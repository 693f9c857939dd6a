"""Port parity: training — ``lm.loss_fn`` and every gradient leaf against
``jax.value_and_grad(repro.models.lm.loss_fn)`` for all ten archs' smoke
configs, with fp32 activations on both sides (``repro``'s
``COMPUTE_DTYPE`` patched to fp32, the port's ``dtype=``) and RWKV-6's
chunked products on fp32 operands on both sides (each package's
``perf.bf16_attn_io`` flag off): the wiring,
with rounding out of the way.  (With bf16 operands each side rounds its own
fp32 values, and a value on a rounding boundary moves the embedding's
gradient by up to 7e-4 in one element.)  Tolerance: the loss and each
gradient leaf within 1e-4·max(1, max|ref|) (fp32 sums in other orders).
A leaf ``repro``
differentiates to zeros that the port's loss does not reach (an unused
embedding table under ``input_mode="embeds"``) must be all zeros there.

Also here: ``forward_train`` refusing params that hold compute copies, the
MoE archs' aux loss against ``repro``'s, and the no-cache training path.
The bf16 losses, the train step, the trainer and the kernels' autograd
Functions are in ``test_torch_train_steps.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import perf
from repro.configs import get_config as j_get_config
from repro_torch import perf as t_perf
from repro.models import lm as j_lm
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm as t_lm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.pytree import flatten

B, T = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under xdist the other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup_arch(arch: str, seed: int = 0):
    """(repro config, port config, repro params, port params as trainable
    fp32 masters, repro batch, port batch) on numpy inputs from ``seed``."""
    jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu", compute_copies=False)
    for p in flatten(tp)[0]:
        p.requires_grad_(True)
    rng = np.random.default_rng(seed + 10)
    labels = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    if jcfg.input_mode == "embeds":
        key = "embeds"
        x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
        tx = torch.from_numpy(x)
    else:
        key = "tokens"
        x = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
        tx = torch.from_numpy(x).long()
    jb = {key: jnp.asarray(x), "labels": jnp.asarray(labels)}
    tb = {key: tx, "labels": torch.from_numpy(labels).long()}
    return jcfg, cfg, jp, tp, jb, tb


def grads_of(loss, params) -> list:
    """Gradients in ``jax.tree`` leaf order; None for an unreached leaf."""
    leaves = flatten(params)[0]
    return list(torch.autograd.grad(loss, leaves, allow_unused=True))


def _scale(a) -> float:
    return max(1.0, float(np.max(np.abs(a))))


@pytest.fixture
def fp32_everywhere(monkeypatch):
    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    with perf.flags(bf16_attn_io=False), t_perf.flags(bf16_attn_io=False):
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_loss_and_every_gradient_match_repro(arch, fp32_everywhere):
    jcfg, cfg, jp, tp, jb, tb = setup_arch(arch)
    jl, jg = jax.value_and_grad(lambda p: j_lm.loss_fn(jcfg, p, jb))(jp)
    tl = t_lm.loss_fn(cfg, tp, tb, dtype=torch.float32)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    assert abs(tl.item() - float(jl)) <= 1e-4 * _scale(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    tgrads = grads_of(tl, tp)
    assert len(tgrads) == len(jleaves)
    for i, (g, want) in enumerate(zip(tgrads, jleaves)):
        want = np.asarray(want, np.float32)
        if g is None:
            assert not want.any(), f"leaf {i} unreached by the port"
            continue
        assert tuple(g.shape) == want.shape
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= 1e-4 * _scale(want), (i, err)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_moe_aux_loss_matches_repro(arch, fp32_everywhere):
    jcfg, cfg, jp, tp, jb, tb = setup_arch(arch, seed=1)
    jh, jaux = j_lm.forward_train(jcfg, jp, jb)
    th, taux = t_lm.forward_train(cfg, tp, tb, dtype=torch.float32)
    assert float(jaux) > 0
    assert abs(taux.item() - float(jaux)) <= 1e-5 * float(jaux)
    h = np.asarray(jh, np.float32)
    assert float(np.max(np.abs(th.detach().numpy() - h))) <= 1e-4 * _scale(h)


def test_forward_train_refuses_compute_copies():
    jcfg = j_get_config("mixtral-8x7b", smoke=True)
    tree = jax.tree_util.tree_map(
        np.asarray, j_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    cfg = get_config("mixtral-8x7b", smoke=True)
    with pytest.raises(ValueError, match="compute copy"):
        t_lm.forward_train(cfg, lm_params_from_numpy(tree, device="cpu"),
                           batch)
    params = lm_params_from_numpy(tree, device="cpu", compute_copies=False)
    params["blocks"]["p0"]["moe"]["wi_c"] = params["blocks"]["p0"]["moe"][
        "wi"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="wi_c"):
        t_lm.forward_train(cfg, params, batch)


def test_training_builds_no_cache(monkeypatch):
    """Full-sequence blocks in training ask Mamba2 for no state."""
    from repro_torch.models import ssm
    seen = []
    real = ssm.mamba2

    def spy(*a, **kw):
        seen.append(kw.get("return_state", False))
        return real(*a, **kw)

    monkeypatch.setattr(ssm, "mamba2", spy)
    _, cfg, _, tp, _, tb = setup_arch("zamba2-2.7b")
    with torch.no_grad():
        t_lm.forward_train(cfg, tp, tb)
    assert seen and not any(seen)
