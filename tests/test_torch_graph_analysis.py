"""The per-device analysis of a sharded step (``launch.graph_analysis``) and
the dry run (``launch.dryrun``) on fake 256- and 512-rank process groups in
this process, under ``FakeTensorMode``: exact hand counts of a sharded
matmul's FLOPs (the local product, not the global one a mode above DTensor
would see), each collective's bytes by ``repro``'s conventions, a stack of
12 groups counting 12 times one group, and a smoke dry-run cell on both
production meshes with ``repro``'s record keys and pinned counts;
the per-token WKV folded (one step counted T times) against the unrolled
loop: equal counts for a forward, within 1 % with the backward; live bytes
counted by storage: a checkpointed region's recomputation, and a view that
outlives its base."""
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


# The smoke train cell's per-device counts before live bytes were counted by
# storage (flops, bytes, collective bytes, ops): the storage count moves
# only the peak of live bytes
SMOKE_TRAIN_COUNTS = {False: (2009277.0, 3232004.0, 513832.0, 1234),
                      True: (2013373.0, 3256580.0, 513832.0, 1234)}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_smoke_dry_run_cell(multi_pod):
    rec = dryrun.lower_cell("smollm-135m", "train_4k", multi_pod,
                            smoke=True)
    assert tuple(rec["hlo"][k] for k in (
        "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
        "ops_per_dev")) == SMOKE_TRAIN_COUNTS[multi_pod]
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
def _wkv_cost(fold: bool, grad: bool, t: int = 24, *,
              backward: bool | None = None, checkpointed: bool = False,
              marks: list | None = None):
    """The counter's cost of the per-token WKV at T t; ``grad``: its inputs
    need gradients, and unless ``backward`` is False it runs the backward;
    ``checkpointed``: under ``loops.checkpoint``, each of its runs
    appending ``loops.checkpointed()`` to ``marks``."""
    from repro_torch.models import loops, ssm
    b, h, d = 2, 4, 16
    marks = [] if marks is None else marks

    def wkv(*a):
        marks.append(loops.checkpointed())
        return ssm._wkv_recurrent(*a)

    with FakeTensorMode():
        args = [torch.empty(b, t, h, d).requires_grad_(grad)
                for _ in range(4)]
        u = torch.empty(h, d).requires_grad_(grad)
        s0 = torch.empty(b, h, d, d).requires_grad_(grad)
        with GraphCounter(fold_loops=fold) as c:
            out, s = (loops.checkpoint(wkv, *args, u, s0) if checkpointed
                      else wkv(*args, u, s0))
            if grad and backward is not False:
                torch.autograd.grad((out.sum(), s.sum()), args + [u, s0])
    assert tuple(out.shape) == (b, t, h, d) and tuple(s.shape) == (b, h, d, d)
    return c.cost


def test_folded_wkv_counts_the_unrolled_loop():
    """One traced step counted T times (``models.loops.scan`` under the
    counter) gives the unrolled loop's FLOPs, bytes and ops exactly."""
    folded, unrolled = _wkv_cost(True, False), _wkv_cost(False, False)
    for f in ("flops", "bytes", "collective_bytes", "ops"):
        assert getattr(folded, f) == getattr(unrolled, f), f
    assert abs(folded.peak_live_bytes - unrolled.peak_live_bytes) \
        <= PEAK_TOL * unrolled.peak_live_bytes


def test_folded_wkv_backward_is_within_a_percent():
    """With the backward: the folded step's backward counted T times, the
    sliced inputs' and stacked outputs' gradients moved otherwise than the
    loop's (``models.loops`` docstring): within 1 % of the unrolled
    count."""
    folded, unrolled = _wkv_cost(True, True), _wkv_cost(False, True)
    for f in ("flops", "bytes", "ops"):
        u = getattr(unrolled, f)
        assert abs(getattr(folded, f) - u) <= 0.01 * u, f
    assert abs(folded.peak_live_bytes - unrolled.peak_live_bytes) \
        <= PEAK_TOL * unrolled.peak_live_bytes


# The folded peak of live bytes against the unrolled loop's: the T - 1
# untraced steps' saved tensors, output slices and carries count toward it
# (``GraphCounter.repeated``); the backward's scatter of the sliced inputs'
# gradients differs from the loop's stack (``models.loops``), so within 10 %.
PEAK_TOL = 0.10


@pytest.mark.parametrize("t", [24, 96])
@pytest.mark.parametrize("grad", [False, True])
def test_folded_wkv_peak_live_bytes_is_the_unrolled_loops(t, grad):
    """The folded step's peak of live bytes grows with T as the unrolled
    loop's does, forward only and with the backward."""
    folded, unrolled = _wkv_cost(True, grad, t), _wkv_cost(False, grad, t)
    assert abs(folded.peak_live_bytes - unrolled.peak_live_bytes) \
        <= PEAK_TOL * unrolled.peak_live_bytes, \
        (folded.peak_live_bytes, unrolled.peak_live_bytes)


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
        rec = dryrun._trace_cell(cfg, shape, mesh, "adamw", "rwkv6-1.6b",
                                 "short", False)
    return {**rec["hlo"], "temp_bytes": rec["memory"]["temp_bytes"]}


def test_folded_rwkv_prefill_cell_counts_the_unrolled_cell():
    """rwkv6's sharded prefill under the baseline (the per-token WKV) at T
    64 on the 16x16 mesh: the folded count is the unrolled count, its peak
    of live bytes too."""
    folded, unrolled = (_rwkv_cell_cost("prefill", f) for f in (True, False))
    for f in ("flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
              "ops_per_dev", "temp_bytes"):
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


@pytest.mark.parametrize("t", [24, 96])
def test_folded_wkv_under_checkpoint_counts_saved_bytes_in_its_backward(t):
    """Under ``loops.checkpoint`` (the remat of ``models.lm``) the folded
    step's forward keeps none of the T - 1 untraced steps' saved tensors:
    its peak is at most two steps' worth above the forward without
    gradients.  Its backward holds them all, as the loop's backward without
    a checkpoint does: within ``PEAK_TOL`` of the unrolled count.  The
    region is marked in its forward and nowhere outside it."""
    from repro_torch.models import loops
    marks = []
    ck_fwd = _wkv_cost(True, True, t, backward=False, checkpointed=True,
                       marks=marks).peak_live_bytes
    ck_bwd = _wkv_cost(True, True, t, checkpointed=True,
                       marks=marks).peak_live_bytes
    assert marks and all(marks) and not loops.checkpointed()
    no_grad = _wkv_cost(True, False, t).peak_live_bytes
    grad_fwd = _wkv_cost(True, True, t, backward=False).peak_live_bytes
    step = (grad_fwd - no_grad) / (t - 1)       # one step's saved bytes
    assert no_grad <= ck_fwd <= no_grad + 2 * step, (ck_fwd, no_grad, step)
    unrolled = _wkv_cost(False, True, t).peak_live_bytes
    assert abs(ck_bwd - unrolled) <= PEAK_TOL * unrolled, (ck_bwd, unrolled)


def test_checkpoint_marks_the_recomputation_too():
    """``loops.checkpoint``'s backward runs the region again with the mark
    on (an unrolled loop saves tensors, so its backward recomputes)."""
    marks = []
    _wkv_cost(False, True, 4, checkpointed=True, marks=marks)
    assert marks == [True, True]


# ------------------------------------------------ live bytes by storage --
@pytest.mark.parametrize("t", [24, 96])
def test_unrolled_wkv_under_checkpoint_counts_the_recomputation(t):
    """The unrolled per-token WKV under ``loops.checkpoint`` with its
    backward: the recomputation holds every step's saved tensors (as the
    checkpoint's detached aliases) until the backward uses them, so its
    peak is the unrolled loop's without the checkpoint, within
    ``PEAK_TOL`` (110,096 B against 643,600 at T 24 while tensor objects
    were counted)."""
    ck = _wkv_cost(False, True, t, checkpointed=True).peak_live_bytes
    plain = _wkv_cost(False, True, t).peak_live_bytes
    assert abs(ck - plain) <= PEAK_TOL * plain, (ck, plain)


def _chain_peak(m: int, k: int, checkpointed: bool) -> float:
    from repro_torch.models import loops

    def region(x, w1, w2, w3):
        return torch.tanh(torch.tanh(torch.tanh(x @ w1) @ w2) @ w3)

    with FakeTensorMode():
        x = torch.empty(m, k).requires_grad_()
        ws = [torch.empty(k, k).requires_grad_() for _ in range(3)]
        with GraphCounter() as c:
            out = (loops.checkpoint(region, x, *ws) if checkpointed
                   else region(x, *ws))
            torch.autograd.grad(out.sum(), [x, *ws])
    return c.cost.peak_live_bytes


@pytest.mark.parametrize("checkpointed", [False, True])
def test_checkpointed_chain_counts_its_recomputed_activations(checkpointed):
    """Three fp32 (M x K)·(K x K) matmul + tanh layers, M 256, K 64, the
    loss their output's sum, x and the weights leaves made outside the
    counter (not counted).  Under ``loops.checkpoint`` the backward first
    needs the last tanh's output, so the region runs again and the
    checkpoint keeps detached aliases of what it saves: h1', h2' and h3'
    (each M x K) beside the output h3, which the caller holds.  The peak
    comes in the third layer's backward: h3, h1', h2' (h3' is freed once
    its tanh backward ran), the gradient of a3 and of h2 (M x K each) and
    of W3 (K x K), and the loss with its seed gradient (4 B each): 5 M K
    4 + K^2 4 + 8 = 344,072 B.  Without the checkpoint the forward saves
    h1, h2 and h3 itself and the same moment holds the same bytes.  (While
    tensor objects were counted, the recomputed aliases went uncounted:
    245,768 B.)"""
    m, k = 256, 64
    assert _chain_peak(m, k, checkpointed) == 5 * m * k * 4 + k * k * 4 + 8


@pytest.mark.parametrize("alias", ["slice", "detach", "view_of_a_view"])
def test_alias_that_outlives_its_base_keeps_its_bytes(alias):
    """base (8 KB) dies while an alias of it lives: the bytes stay live
    until the alias dies, then are free.  b beside the alias reads 16 KB;
    after the alias dies, d and e beside b read 24 KB, not 32."""
    make = {"slice": lambda t: t[:4], "detach": lambda t: t.detach(),
            "view_of_a_view": lambda t: t.view(-1)[8:].view(-1, 4)}[alias]
    with FakeTensorMode():
        a = torch.empty(64, 32)
        with GraphCounter() as c:
            base = a + 1
            view = make(base)
            del base
            b = a * 2
            assert c.cost.peak_live_bytes == 2 * 8192
            del view
            d, e = a * 3, a * 4
    assert c.cost.peak_live_bytes == 3 * 8192
    del b, d, e
