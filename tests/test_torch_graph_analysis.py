"""The per-device analysis of a sharded step (``launch.graph_analysis``) and
the dry run (``launch.dryrun``) on fake 256- and 512-rank process groups in
this process, under ``FakeTensorMode``: exact hand counts of a sharded
matmul's FLOPs (the local product, not the global one a mode above DTensor
would see), each collective's bytes by ``repro``'s conventions, a stack of
12 groups counting 12 times one group, and a smoke dry-run cell on both
production meshes with ``repro``'s record keys; the per-token WKV folded
(one step counted T times) against the unrolled loop: equal counts for a
forward, within 1 % with the backward."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import GraphCounter
from repro_torch.launch.mesh import make_production_mesh


@pytest.fixture
def mesh16():
    with dryrun.fake_world(256):
        yield make_production_mesh(device_type="cpu")


def _dt(shape, mesh, placements):
    return DTensor.from_local(torch.empty(shape), mesh, placements,
                              run_check=False)


def test_sharded_matmul_counts_the_local_product(mesh16):
    m, k, n = 1024, 512, 2048
    with FakeTensorMode():
        x = _dt((m // 16, k), mesh16, [Shard(0), Replicate()])
        w = _dt((k, n // 16), mesh16, [Replicate(), Shard(1)])
        with GraphCounter() as c:
            y = x @ w
    assert tuple(y.shape) == (m, n)
    assert c.cost.flops == 2 * (m // 16) * k * (n // 16)
    assert c.cost.collective_bytes == 0
    assert c.cost.bytes == 4 * ((m // 16) * k + k * (n // 16)
                                + (m // 16) * (n // 16))


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter"])
def test_collective_bytes_follow_repro(mesh16, kind):
    """all-gather: the result; all-reduce: 2x the result; reduce-scatter:
    the operand (fp32, per device)."""
    rows, cols = 64, 32
    with FakeTensorMode():
        if kind == "all-gather":
            d = _dt((rows, cols), mesh16, [Replicate(), Shard(0)])
            want = 4 * rows * 16 * cols
            go = [Replicate(), Replicate()]
        elif kind == "all-reduce":
            d = _dt((rows, cols), mesh16, [Replicate(), Partial()])
            want = 2 * 4 * rows * cols
            go = [Replicate(), Replicate()]
        else:
            d = _dt((rows, cols), mesh16, [Replicate(), Partial()])
            want = 4 * rows * cols
            go = [Replicate(), Shard(0)]
        with GraphCounter() as c:
            d.redistribute(mesh16, go)
    assert c.cost.collectives == {kind: want}
    assert c.cost.collective_bytes == want


def _prefill_flops(n_layers: int) -> float:
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("smollm-135m", smoke=True)
    cfg = type(cfg)(**{**cfg.__dict__, "n_layers": n_layers})
    with FakeTensorMode():
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
        tokens = torch.zeros((2, 16), dtype=torch.int32)
        with GraphCounter() as c:
            lm.prefill(cfg, params, {"tokens": tokens}, 16,
                       dtype=torch.float32)
    return c.cost.flops


def test_twelve_groups_count_twelve_times():
    one, two, twelve = (_prefill_flops(n) for n in (1, 2, 12))
    group = two - one
    assert group > 0
    assert twelve - one == 11 * group


@pytest.mark.parametrize("multi_pod", [False, True])
def test_smoke_dry_run_cell(multi_pod):
    rec = dryrun.lower_cell("smollm-135m", "train_4k", multi_pod,
                            smoke=True)
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    for key in ("arch", "shape", "kind", "optimizer", "seq_len",
                "global_batch", "params", "active_params", "lower_s",
                "memory", "hlo", "roofline"):
        assert key in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert {"flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
            "collectives"} <= set(rec["hlo"])
    assert rec["hlo"]["flops_per_dev"] > 0
    assert rec["hlo"]["collectives"]["all-gather"] > 0     # ZeRO-3 gathers
    assert rec["hlo"]["collectives"]["reduce-scatter"] > 0  # and gradients
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_constrain_tokens_shards_batch_and_sequence(mesh16):
    """``repro``'s anchors on DTensors: under the ambient mesh the tokens go
    to batch over 'data' and sequence over 'model' where they divide, and
    without a mesh x comes back as it is."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import sharding_hints as hints
    with FakeTensorMode():
        x = _dt((32, 64, 8), mesh16, [Replicate(), Replicate()])
        assert hints.constrain_tokens(x) is x            # no ambient mesh
        with set_mesh(mesh16):
            y = hints.constrain_tokens(x)
            z = hints.constrain(_dt((8, 64, 8), mesh16,
                                    [Replicate(), Replicate()]),
                                (hints.BATCH, "model", None))
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(y.to_local().shape) == (2, 4, 8)
    assert tuple(z.placements) == (Replicate(), Shard(1))  # 8 rows < 16


# ------------------------------------------- folded per-token recurrences --
def _wkv_cost(fold: bool, grad: bool):
    from repro_torch.models import ssm
    b, t, h, d = 2, 24, 4, 16
    with FakeTensorMode():
        args = [torch.empty(b, t, h, d).requires_grad_(grad)
                for _ in range(4)]
        u = torch.empty(h, d).requires_grad_(grad)
        s0 = torch.empty(b, h, d, d).requires_grad_(grad)
        with GraphCounter(fold_loops=fold) as c:
            out, s = ssm._wkv_recurrent(*args, u, s0)
            if grad:
                torch.autograd.grad((out.sum(), s.sum()), args + [u, s0])
    assert tuple(out.shape) == (b, t, h, d) and tuple(s.shape) == (b, h, d, d)
    return c.cost


def test_folded_wkv_counts_the_unrolled_loop():
    """One traced step counted T times (``models.loops.scan`` under the
    counter) gives the unrolled loop's FLOPs, bytes and ops exactly."""
    folded, unrolled = _wkv_cost(True, False), _wkv_cost(False, False)
    for f in ("flops", "bytes", "collective_bytes", "ops"):
        assert getattr(folded, f) == getattr(unrolled, f), f


def test_folded_wkv_backward_is_within_a_percent():
    """With the backward: the folded step's backward counted T times, the
    sliced inputs' and stacked outputs' gradients moved otherwise than the
    loop's (``models.loops`` docstring): within 1 % of the unrolled
    count."""
    folded, unrolled = _wkv_cost(True, True), _wkv_cost(False, True)
    for f in ("flops", "bytes", "ops"):
        u = getattr(unrolled, f)
        assert abs(getattr(folded, f) - u) <= 0.01 * u, f


def _rwkv_cell_cost(kind: str, fold: bool):
    from repro_torch import perf
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import graph_analysis
    cfg = get_config("rwkv6-1.6b", smoke=True)
    shape = ShapeSpec("short", kind, 64, 16)
    real = graph_analysis.GraphCounter.__init__
    with perf.baseline(), dryrun.fake_world(256), pytest.MonkeyPatch.context(
    ) as mp:
        mp.setattr(graph_analysis.GraphCounter, "__init__",
                   lambda self, fold_loops=True: real(self, fold))
        mesh = make_production_mesh(device_type="cpu")
        return dryrun._trace_cell(cfg, shape, mesh, "adamw", "rwkv6-1.6b",
                                  "short", False)["hlo"]


def test_folded_rwkv_prefill_cell_counts_the_unrolled_cell():
    """rwkv6's sharded prefill under the baseline (the per-token WKV) at T
    64 on the 16x16 mesh: the folded count is the unrolled count."""
    folded, unrolled = (_rwkv_cell_cost("prefill", f) for f in (True, False))
    for f in ("flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
              "ops_per_dev"):
        assert folded[f] == unrolled[f], f


def test_folded_rwkv_train_cell_counts_the_unrolled_cell():
    """The same in a train step (the backward as in
    ``test_folded_wkv_backward_is_within_a_percent``, and the loop's last
    carry gradient, none in the loop and zeros in the folded step): within
    1 % of the unrolled count."""
    folded, unrolled = (_rwkv_cell_cost("train", f) for f in (True, False))
    for f in ("flops_per_dev", "bytes_per_dev", "ops_per_dev"):
        assert abs(folded[f] - unrolled[f]) <= 0.01 * unrolled[f], f
    assert folded["collective_bytes_per_dev"] == \
        unrolled["collective_bytes_per_dev"]
