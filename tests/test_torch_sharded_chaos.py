"""Port: the sharded consume scan under chaos against the reference.

The cases of ``test_torch_sharded.py`` (G in {1, 2, 4} shards x
placements x link budgets {None, 1, 2}) under its chaos spec of all four
axes (slowdown, degradation, node loss, grants; adaptive deadlines): the
same checksums, ``info`` columns, final ``est_q``, events and state as the
reference's flat plane.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded import CASES, check_consume  # noqa: E402


@pytest.mark.parametrize("G,placement,budget", CASES)
def test_sharded_consume_under_chaos_matches(G, placement, budget):
    check_consume(G, placement, budget, chaos=True)
