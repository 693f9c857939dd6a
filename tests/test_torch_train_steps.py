"""Port parity: training in bf16, the train step, the trainer, and the
autograd Functions of the two kernels on the training path.

* bf16 loss (bf16 activations on both sides) for all ten archs' smoke
  configs: within 2e-2·max(1, |ref|) of ``repro``'s (both round every
  layer's outputs to bf16, in other summation orders; the port's attention
  runs the flash kernel's plain version where ``repro`` runs a dense
  softmax).
* one AdamW train step (``launch.steps.make_train_step``) against
  ``repro``'s loss, ``jax.grad`` and ``adamw().update``, fp32 activations
  on both sides: loss 1e-5 relative; moments within 1e-5·max(1, max|ref|)
  per leaf; parameters within 1e-6·max(1, max|ref|) plus what a gradient
  held to ``test_torch_train``'s 1e-4·max(1, max|g|) can move the first
  Adam step, lr·min(2, 2·that / (|g| + eps)) per element: the step is
  lr·g / (|g| + eps), so an element whose gradient is near zero turns with
  any error in it.
* ``FlashAttention`` and ``Conv1dCausal`` on the CPU against autograd
  through the plain versions: the forward equal; gradients equal where the
  Function differentiates the same graph in one piece (conv1d; flash with
  T <= ``FLASH_BWD_ROWS``), else within 1e-5·max(1, max|ref|) in fp32 (dk
  and dv summed over blocks in another order) and one bf16 step of the
  largest, 2^-7·max(1, max|ref|), in bf16 (each block's gradient is rounded
  to bf16 before the fp32 sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as j_lm
from repro.optim import adamw as j_adamw
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import conv1d as c1_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.ref import FLASH_REF_ROWS
from repro_torch.launch import steps, train
from repro_torch.models import lm as t_lm
from repro_torch.optim import opt_state_from_numpy
from repro_torch.pytree import leaves
from test_torch_train import setup_arch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_repro(arch):
    jcfg, cfg, jp, tp, jb, tb = setup_arch(arch)
    jl = float(j_lm.loss_fn(jcfg, jp, jb))
    with torch.no_grad():
        tl = t_lm.loss_fn(cfg, tp, tb)
    assert tl.dtype == torch.float32
    assert abs(float(tl) - jl) <= 2e-2 * max(1.0, abs(jl))


def test_adamw_train_step_matches_repro(monkeypatch):
    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    jcfg, cfg, jp, tp, jb, tb = setup_arch("zamba2-2.7b", seed=2)
    jopt = j_adamw(lr=1e-3)
    jl, jg = jax.value_and_grad(lambda p: j_lm.loss_fn(jcfg, p, jb))(jp)
    jp2, js2 = jopt.update(jg, jopt.init(jp), jp)
    mk = steps.make_train_step(cfg, "adamw", 1e-3, dtype=torch.float32,
                               device="cpu")
    state = {"params": tp, "opt": opt_state_from_numpy(
        jopt.init(jp), device="cpu"), "step": torch.zeros((), dtype=torch.int32)}
    state, metrics = mk["fn"](state, tb)
    assert int(metrics["step"]) == 1 and int(state["opt"].step) == 1
    assert abs(float(metrics["loss"]) - float(jl)) <= 1e-5 * float(jl)
    scale = lambda a: max(1.0, float(np.max(np.abs(a))))
    for got, want in zip(leaves(state["opt"]),
                         jax.tree_util.tree_leaves(js2)):
        want = np.asarray(want, np.float32)
        assert np.max(np.abs(got.float().numpy() - want)) <= \
            1e-5 * scale(want)
    for got, want, g in zip(leaves(state["params"]),
                            jax.tree_util.tree_leaves(jp2),
                            jax.tree_util.tree_leaves(jg)):
        want, g = np.asarray(want, np.float32), np.asarray(g, np.float32)
        turn = np.minimum(2.0, 2e-4 * scale(g) / (np.abs(g) + 1e-8))
        tol = 1e-6 * scale(want) + 1e-3 * turn
        assert np.all(np.abs(got.detach().numpy() - want) <= tol)


def test_adamw_trains_tiny_lm():
    """The port of tests/test_train.py::test_adamw_trains_tiny_lm: 20 steps
    on one batch, the loss must drop measurably."""
    cfg = get_config("smollm-135m", smoke=True)
    mk = steps.make_train_step(cfg, "adamw", 3e-3, device="cpu")
    state = mk["make_init"](0)()
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    losses = []
    for _ in range(20):
        state, metrics = mk["fn"](state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def _rand(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


FLASH_CASES = [  # (B, T, H, Kh, dh, window, softcap)
    (2, 37, 4, 2, 16, 0, 0.0),
    (1, 700, 2, 1, 16, 100, 0.0),
    (1, FLASH_REF_ROWS + 52, 2, 1, 16, 0, 30.0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_function_matches_autograd_of_the_plain_version(case, dtype):
    b, t, h, kh, dh, window, cap = case
    q, k, v = (_rand((b, t, n, dh), dtype, i) for i, n in
               enumerate((h, kh, kh)))
    g = _rand((b, t, h, dh), dtype, 7)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa_mod.flash_attention(*ins, window=window, softcap=cap)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, g)
    ref_ins = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = fa_mod.flash_attention_plain(*ref_ins, window=window, softcap=cap)
    want = torch.autograd.grad(ref, ref_ins, g)
    assert torch.equal(out, ref)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        scale = max(1.0, w.abs().max().item())
        if t <= fa_mod.FLASH_BWD_ROWS:
            assert torch.equal(a, w)
        elif dtype == torch.float32:
            assert (a - w).abs().max().item() <= 1e-5 * scale
        else:
            assert (a.float() - w.float()).abs().max().item() <= \
                2.0 ** -7 * scale


@pytest.mark.parametrize("fl,strided", [(4, True), (2, False), (3, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_conv1d_function_matches_autograd_of_the_plain_version(fl, strided,
                                                               dtype):
    base = _rand((2, 19, 40), dtype, 1)
    w = _rand((fl, 24), torch.float32, 2)
    g = _rand((2, 19, 24), dtype, 3)
    outs = []
    for fn in (c1_mod.conv1d_causal, c1_mod.conv1d_causal_plain):
        bx = base.clone().requires_grad_()
        x = bx[:, :, 8:32] if strided else bx[:, :, :24]
        wx = w.clone().requires_grad_()
        out = fn(x, wx)
        outs.append((out, *torch.autograd.grad(out, (bx, wx), g)))
    assert outs[0][0].grad_fn is not None
    for a, w_ in zip(outs[0], outs[1]):
        assert a.dtype == w_.dtype and torch.equal(a, w_)


def test_functions_reach_the_kernels_only_on_cuda_tensors():
    """On the CPU the Functions run the plain versions: no launch."""
    fa_mod.flash_attention.launches = c1_mod.conv1d_causal.launches = 0
    x = _rand((1, 8, 2, 16), torch.float32, 0).requires_grad_()
    fa_mod.flash_attention(x, x, x).sum().backward()
    c1_mod.conv1d_causal(x[:, :, 0], torch.ones(4, 16)).sum().backward()
    assert fa_mod.flash_attention.launches == c1_mod.conv1d_causal.launches \
        == 0


def test_trainer_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--smoke", "--seq-len", "32",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu", "--event-log", str(tmp_path / "ev.jsonl")]
    train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "done at step 4" in out and "tok/s" in out
    assert "resumed" not in out and "step     0  loss" in out
    state = train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4 (data cursor 4)" in out
    assert "done at step 6" in out and int(state["step"]) == 6
    assert torch.isfinite(torch.stack([p.detach().float().abs().max()
                                       for p in leaves(state["params"])])
                          ).all()


def test_trainer_checkpoints_under_tmpdir_by_default(tmp_path, monkeypatch):
    """Without --ckpt-dir the trainer writes (and resumes from) a directory
    under the temp dir, never one fixed path that other runs share."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = train.arg_parser().parse_args([])
    assert args.ckpt_dir == str(tmp_path / "repro_torch_ckpt")
    assert args.device == "cuda"
