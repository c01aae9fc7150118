"""Optimizers over the port's parameter tree: AdamW, Adafactor, schedules,
clipping (``repro.optim``).

AdamW keeps float32 moments; Adafactor a factored second moment (the
reference gives it to llama4-maverick, ``launch/steps.py``'s
``OPT_FOR_ARCH``). Both update in place and take the reference's rank of
each leaf (``common.leaf_ndim``) for weight decay and factoring.
"""

from .adafactor import adafactor
from .adamw import adamw
from .common import clip_by_global_norm, global_norm, param_tree
from .schedules import cosine_warmup, linear_warmup

OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, lr, **kw):
    return OPTIMIZERS[name](lr, **kw)


__all__ = ["adamw", "adafactor", "cosine_warmup", "linear_warmup",
           "clip_by_global_norm", "global_norm", "make_optimizer",
           "param_tree", "OPTIMIZERS"]
