"""Distribution on ``torch.distributed``: logical-axis sharding rules
resolved to DTensor placements, activation constraints
(``repro.distributed``)."""

from .activations import activation_constraint, set_activation_sharding
from .sharding import (RULES_SERVE, RULES_TRAIN, batch_shardings,
                       named_sharding_for, placements_for, rules_for,
                       shardings_for_tree)

__all__ = ["RULES_SERVE", "RULES_TRAIN", "named_sharding_for",
           "placements_for", "shardings_for_tree", "batch_shardings",
           "rules_for", "activation_constraint", "set_activation_sharding"]
