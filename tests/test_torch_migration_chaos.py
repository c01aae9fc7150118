"""Port: the consume scan with the §12 lifecycle under chaos node loss.

Four shards, block placement, a link budget of 2, the compressed tier on,
and shard 0 lost at step 20 (the reference's ``TestChaosComposition``
spec): the port's flat plane against the reference's in every integer,
checksum, table and event. The death re-homes the current home table and
invalidates every page then homed on the dead shard; carried proposals
toward it are dropped and count as pollution, and no migration leaves the
dead NIC after the death. (A file of its own, so that the chaos compile of
the reference shares no worker's budget with ``test_torch_migration.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_migration import (MIG_COMP, _scheds, check_same,  # noqa: E402
                                  run_both)


def test_consume_with_migration_under_node_loss_matches():
    sched = _scheds()
    fabric = dict(n_shards=4, placement="block", link_budget=2,
                  near_delay=1, far_delay=3)
    spec = dict(node_loss=(0, 20))
    want, got = run_both(sched, fabric, MIG_COMP, chaos=spec)
    tnp = check_same(want, got, sched, fabric)
    mg = tnp["mig_on_shard"]
    assert int(mg[:20, 0].sum()) > 0 and int(mg[20:, 0].sum()) == 0
    assert int(tnp["demoted"].sum()) > 0
    assert "est_q" in tnp
    # the dropped moves show as pollution against the two-tier chaos run
    _, two = run_both(sched, fabric, None, chaos=spec)
    pol = lambda st: int(st["pool_meta"]["n_pollution"].sum())
    assert pol(got[0]) > pol(two[0])
    assert not (np.asarray(got[0]["tier"]["home"]) == 0).any()
