"""Port parity: the optimizers, schedules and gradient compression against
``repro.optim``.

Both packages get the same numpy params and gradients.  Tolerances:

* fp32 parameters and moments after 3 updates: 1e-6·max(1, max|ref|) per
  leaf (the same fp32 arithmetic; XLA and torch sum the clipping norm and
  Adafactor's means in other orders);
* Lion's bf16 moment: exact (one rounding of the same fp32 value);
* schedules: 1e-6 relative at every step checked (one fp32 cos/sqrt);
* compression: int8 codes and scales exact, the error-feedback residual
  1e-6 (the same fp32 arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as j_comp
from repro.optim import make_optimizer as j_make
from repro.optim import schedule as j_sched
from repro_torch.models.convert import to_numpy
from repro_torch.optim import compression as t_comp
from repro_torch.optim import make_optimizer as t_make
from repro_torch.optim import opt_state_from_numpy
from repro_torch.optim import schedule as t_sched
from repro_torch.pytree import leaves

OPTS = ["adamw", "adafactor", "lion", "sgdm"]


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": f(6, 5), "b": {"c": f(5), "m": f(2, 3, 4)}, "s": f(1)}


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("name", OPTS)
def test_three_updates_match_repro(name):
    params = _tree(0)
    jo, to = j_make(name, 0.05), t_make(name, 0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    assert type(ts).__name__ == type(js).__name__
    assert ts._fields == js._fields
    for i in range(3):
        grads = _tree(10 + i, scale=0.7)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tp2, ts = to.update(_torch(grads), ts, tp)
        assert tp2 is tp                         # updated in place
    assert int(ts.step) == int(js.step) == 3
    for got, want in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
        want = _f32(want)
        assert np.abs(_f32(got) - want).max() <= 1e-6 * max(
            1.0, np.abs(want).max())
    for got, want in zip(leaves(ts), jax.tree_util.tree_leaves(js)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        if got.dtype == torch.bfloat16:          # Lion's moment
            assert np.array_equal(_f32(got), _f32(want))
        else:
            w = _f32(want)
            assert np.abs(_f32(got) - w).max() <= 1e-6 * max(
                1.0, np.abs(w).max())


@pytest.mark.parametrize("name", OPTS)
def test_state_crosses_between_the_packages(name):
    """repro's state -> the port's (opt_state_from_numpy) -> numpy again
    (to_numpy): the same leaves, dtypes kept on the port's side."""
    params = _tree(1)
    js = j_make(name, 0.1).init(jax.tree_util.tree_map(jnp.asarray, params))
    js = jax.tree_util.tree_map(lambda a: a + 1, js)
    ts = opt_state_from_numpy(js, device="cpu")
    assert type(ts).__name__ == type(js).__name__
    back = to_numpy(ts)
    for t, n, j in zip(leaves(ts), leaves(back), jax.tree_util.tree_leaves(js)):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert np.array_equal(n, _f32(j))


def test_state_converter_refuses_what_is_not_a_state():
    """A NamedTuple that is not one of repro's states, or one whose fields
    differ from the port's, is refused by name."""
    from collections import namedtuple
    other = namedtuple("AdamState", ["step", "mu"])(0, {})
    for state in (namedtuple("SomeState", ["step"])(0), other):
        with pytest.raises(ValueError, match="not an optimizer state"):
            opt_state_from_numpy(state, device="cpu")


@pytest.mark.parametrize("name", OPTS)
def test_optimizer_reduces_quadratic(name):
    """The port of tests/test_train.py's test of the same name."""
    opt = t_make(name, lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.ones((2, 4))}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        ps = [params["b"], params["w"]]
        for p in ps:
            p.requires_grad_(True)
        gb, gw = torch.autograd.grad(loss(params), ps)
        params, state = opt.update({"w": gw, "b": gb}, state, params)
    with torch.no_grad():
        assert float(loss(params)) < 0.25 * l0


def test_adafactor_state_is_factored():
    st = t_make("adafactor", 1e-2).init({"w": torch.zeros((64, 32)),
                                         "v": torch.zeros((16,))})
    assert st.vr["w"].shape == (64,)
    assert st.vc["w"].shape == (32,)
    assert st.vr["v"].shape == (16,)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches(max_norm):
    from repro.optim import clip_by_global_norm as j_clip
    from repro_torch.optim import clip_by_global_norm as t_clip
    g = _tree(3)
    jg, jn = j_clip(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tg, tn = t_clip(_torch(g), max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for a, b in zip(leaves(tg), jax.tree_util.tree_leaves(jg)):
        assert np.allclose(_f32(a), _f32(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("which", ["constant", "warmup_cosine",
                                   "inverse_sqrt"])
def test_schedules_match(which):
    args = {"constant": (3e-4,), "warmup_cosine": (1e-3, 10, 50, 0.1),
            "inverse_sqrt": (1e-3, 10)}[which]
    jf, tf = getattr(j_sched, which)(*args), getattr(t_sched, which)(*args)
    for s in list(range(0, 60)) + [1000]:
        want = float(jf(jnp.int32(s)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert abs(float(got) - want) <= 1e-6 * abs(want), (s, got, want)


def test_compression_matches_with_error_feedback():
    g = {"w": np.linspace(-1, 1, 128).astype(np.float32),
         "v": np.random.default_rng(4).standard_normal(37).astype(np.float32)}
    j_res = t_res = None
    for _ in range(5):
        (jq, js), j_res = j_comp.error_feedback_compress(
            jax.tree_util.tree_map(jnp.asarray, g), j_res,
            j_comp.compress_int8, j_comp.decompress_int8)
        (tq, ts), t_res = t_comp.error_feedback_compress(
            _torch(g), t_res, t_comp.compress_int8, t_comp.decompress_int8)
        for a, b in zip(leaves(tq), jax.tree_util.tree_leaves(jq)):
            assert a.dtype == torch.int8 and np.array_equal(a.numpy(),
                                                            np.asarray(b))
        for a, b in zip(leaves(ts), jax.tree_util.tree_leaves(js)):
            assert float(a) == float(b)
        for a, b in zip(leaves(t_res), jax.tree_util.tree_leaves(j_res)):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6
    jb, tb = j_comp.compress_bf16(jnp.asarray(g["v"])), \
        t_comp.compress_bf16(torch.from_numpy(g["v"]))
    assert tb.dtype == torch.bfloat16
    assert np.array_equal(_f32(t_comp.decompress_bf16(tb)),
                          _f32(j_comp.decompress_bf16(jb)))


def test_int8_rounds_half_to_even():
    """127 / max|g| puts g = 0.5 * scale exactly on a half: both packages
    round it to 0, and 1.5 * scale to 2."""
    g = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    jq, _ = j_comp.compress_int8({"g": jnp.asarray(g)})
    tq, _ = t_comp.compress_int8({"g": torch.from_numpy(g)})
    assert np.array_equal(tq["g"].numpy(), np.asarray(jq["g"]))
    assert tq["g"].tolist() == [127, 0, 2, -2]


def test_error_feedback_keeps_drift_small():
    """The port of tests/test_train.py::test_gradient_compression_error_
    feedback."""
    g = {"w": torch.linspace(-1, 1, 128)}
    residual = None
    acc_true, acc_q = torch.zeros(128), torch.zeros(128)
    for _ in range(50):
        (q, s), residual = t_comp.error_feedback_compress(
            g, residual, t_comp.compress_int8, t_comp.decompress_int8)
        acc_true += g["w"]
        acc_q += t_comp.decompress_int8(q, s)["w"]
    assert float(torch.max(torch.abs(acc_true - acc_q))) < 0.05
