"""Port: the GPipe pipeline (``repro_torch.distributed.pipeline``) on four
gloo ranks, against sequential execution of the same stages.

The reference's own pipeline test (``tests/test_pipeline.py``) has been
red since the seed, so sequential execution is the oracle, as in that
test: its shapes (4 stages, D 8, B 8, ``stage_fn = tanh(h @ w)``), the
stage weights and the batch made from numpy seeds, the sequential result
and its gradients computed by JAX (``jax.grad`` of the loss over the
stages applied in turn). Four gloo ranks, spawned once for the file from
a ``FileStore`` under the test's tmp dir, each hold only their own
stage's weights and run ``pipeline_forward`` at 4 (the reference's), 8,
2 and the default number of microbatches, and once on weights held as a
DTensor sharded by stage; each rank's result must equal the sequential
one within 1e-5, and each stage's gradient (the loss ``sum(y ** 2)``
divided by the stage count on every rank: the all-reduce's backward sums
the ranks') the sequential gradient of that stage within 1e-5.
``bubble_fraction`` equals the reference's exactly on a grid of stages
and microbatches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed.pipeline import bubble_fraction as j_bubble  # noqa: E402
from repro_torch.distributed.pipeline import (bubble_fraction,  # noqa: E402
                                              pipeline_forward)

WORLD, D, B = 4, 8, 8
TOL = 1e-5
CASES = {"micro4": 4, "micro8": 8, "micro2": 2, "default": None}


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((WORLD, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, x


def _stage_fn(w, h):
    return torch.tanh(h @ w)


def _case(mesh, rank, n_micro, dtensor=False):
    """This rank's result and its stage's gradient."""
    w, x = _inputs()
    if dtensor:
        from torch.distributed.tensor import Shard, distribute_tensor
        full = torch.from_numpy(w)
        params = distribute_tensor(full, mesh, [Shard(0)]).requires_grad_()
    else:
        params = torch.from_numpy(w[rank:rank + 1]).requires_grad_()
    y = pipeline_forward(_stage_fn, params, torch.from_numpy(x), mesh=mesh,
                         axis="pod", n_micro=n_micro)
    ((y ** 2).sum() / WORLD).backward()
    grad = params.grad.to_local() if dtensor else params.grad
    return {"y": y.detach().numpy(), "grad": grad[0].numpy()}


def _rank_main(rank, world, store_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        res = {name: _case(mesh, rank, n) for name, n in CASES.items()}
        res["dtensor"] = _case(mesh, rank, 4, dtensor=True)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("pipeline")
    mp.start_processes(_rank_main, args=(WORLD, str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def sequential():
    """The stages applied in turn, by JAX: the result and the gradient of
    ``sum(y ** 2)`` with respect to each stage's weights."""
    w, x = _inputs()

    def run(ws):
        h = jnp.asarray(x)
        for s in range(WORLD):
            h = jnp.tanh(h @ ws[s])
        return h

    y = run(jnp.asarray(w))
    g = jax.grad(lambda ws: jnp.sum(run(ws) ** 2))(jnp.asarray(w))
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("case", list(CASES) + ["dtensor"])
def test_pipeline_matches_sequential_execution(ranks, sequential, case):
    y_seq, g_seq = sequential
    for rank, res in enumerate(ranks):
        got = res[case]
        assert got["y"].shape == y_seq.shape
        assert np.abs(got["y"] - y_seq).max() <= TOL, (case, rank)
        assert np.abs(got["grad"] - g_seq[rank]).max() <= TOL, (case, rank)
    assert np.abs(g_seq).max() > 100 * TOL


def test_pipeline_matches_the_torch_sequential_stages(ranks):
    """The same oracle in PyTorch: the result of the stages in turn."""
    w, x = _inputs()
    h = torch.from_numpy(x)
    for s in range(WORLD):
        h = _stage_fn(torch.from_numpy(w[s]), h)
    for res in ranks:
        assert np.abs(res["micro4"]["y"] - h.numpy()).max() <= TOL


def test_bubble_fraction_is_the_reference_s():
    for stages in range(1, 9):
        for micro in range(1, 17):
            assert bubble_fraction(stages, micro) == j_bubble(stages, micro)
    assert bubble_fraction(4, 4) == 3 / 7
    assert bubble_fraction(1, 8) == 0.0


def test_batch_must_divide_into_microbatches():
    class Mesh:
        mesh_dim_names = ("pod",)

        def size(self, dim):
            return 4

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None

    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(_stage_fn, torch.zeros(1, D, D), torch.zeros(6, D),
                         mesh=Mesh(), n_micro=4)
