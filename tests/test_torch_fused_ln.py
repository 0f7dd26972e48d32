"""Port parity: the fused LayerNorm + projection (``ln_matmul``) and the
GPT's ``fused_ln`` path (deepspeed_tpu_torch) against the JAX package,
whose ``ln_matmul`` runs its Pallas kernels in interpret mode on the CPU.

On the CPU the port's ``ln_matmul`` runs its plain versions (the forward
and the backward written after the TPU kernel's formulas);
``chip_smoke.py`` holds the CUDA kernels against the same plain versions
on the GPU. Tolerances, max |diff|:

- forward, fp32 2e-5 (the same fp32 arithmetic summed in another order)
  and bf16 2e-2 (outputs near 1, where a bf16 step is 2**-8 to 2**-7:
  the two sides may round an fp32 value that differs in its last bits to
  neighbouring bf16 values);
- the five gradients, fp32 2e-4 and bf16 5e-2, each relative to
  max(1, the largest |element| of JAX's gradient) (dW and the row sums
  reach ~10 over 256 rows, where a bf16 step is 2**-5); 5e-4 with four
  JAX row blocks summed (n = 512);
- the GPT: loss 1e-5 relative, every gradient 5e-4 of max(1e-3, its
  largest element); the engine: losses 1e-5 relative, params 1e-5.

Every model and engine comparison also checks that both sides ran fused:
the port counts its plain forward, the JAX side counts its ``ln_matmul``
through a monkeypatch (its gate leaves a site unfused without a word, and
two unfused models agree just as well).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.ops.transformer import fused as jfused
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models import (gpt_params_from_flax,
                                        init_flax_gpt_params, make_gpt)
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import fused

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

EPS = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _inputs(seed, n, d, f):
    """x, gamma, beta, w [D, F] (JAX's layout), bias, dy; fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    beta = (0.1 * rng.normal(size=d)).astype(np.float32)
    w = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=f)).astype(np.float32)
    dy = rng.normal(size=(n, f)).astype(np.float32)
    return x, gamma, beta, w, bias, dy


def _jax_side(arrs, dtype, act, block_rows=128):
    """JAX's ln_matmul (Pallas, interpret) and jax.grad of sum(y * dy):
    y and (dx, dgamma, dbeta, dw [D, F], dbias) as fp32 numpy. x, w and
    bias in ``dtype`` (the model passes ``wk.astype(dt)``), gamma and beta
    fp32."""
    x, gamma, beta, w, bias, dy = arrs
    jdt = DTYPES[dtype][0]

    def f(x, gamma, beta, w, bias):
        y = jfused.ln_matmul(x, gamma, beta, w, bias, eps=EPS,
                             activation=act, block_rows=block_rows,
                             interpret=True)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, y), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(w, jdt), jnp.asarray(bias, jdt))
    f32 = [np.asarray(g.astype(jnp.float32)) for g in grads]
    return np.asarray(y.astype(jnp.float32)), f32


def _port_side(arrs, dtype, act):
    """The port's ln_matmul (plain versions on the CPU) and its autograd:
    y and (dx, dgamma, dbeta, dw [D, F], dbias) as fp32 numpy."""
    x, gamma, beta, w, bias, dy = arrs
    tdt = DTYPES[dtype][1]
    ts = [torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
          torch.from_numpy(beta), torch.from_numpy(w.T.copy()).to(tdt),
          torch.from_numpy(bias).to(tdt)]
    ts = [t.requires_grad_() for t in ts]
    y = fused.ln_matmul(*ts, eps=EPS, activation=act)
    assert y.dtype == tdt
    y.float().backward(torch.from_numpy(dy))
    grads = [t.grad.float().numpy() for t in ts]
    grads[3] = grads[3].T
    return y.detach().float().numpy(), grads


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def sides():
    """Both sides' y and gradients on one input set (n 256, D 128, F 384),
    each (dtype, activation) computed once for the forward and the
    gradient tests."""
    arrs = _inputs(0, 256, 128, 384)
    cache = {}

    def get(dtype, act):
        if (dtype, act) not in cache:
            cache[(dtype, act)] = (_jax_side(arrs, dtype, act),
                                   _port_side(arrs, dtype, act))
        return cache[(dtype, act)]

    return get


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_forward_matches_jax(act, dtype, tol, sides):
    (want, _), (got, _) = sides(dtype, act)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_gradients_match_jax(act, dtype, tol, sides):
    (_, want), (_, got) = sides(dtype, act)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got,
                          want):
        _close(g, w, tol, name)


def test_row_block_accumulation_matches_jax():
    """n = 512 over JAX row blocks of 128: the TPU kernel sums dW, dbias,
    dgamma and dbeta across 4 grid steps."""
    arrs = _inputs(2, 512, 128, 256)
    _, want = _jax_side(arrs, "float32", "gelu")
    _, got = _port_side(arrs, "float32", "gelu")
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got,
                          want):
        _close(g, w, 5e-4, name)


@pytest.mark.parametrize("dtype,tols", [("float32", (2e-5, 2e-4)),
                                        ("bfloat16", (2e-2, 5e-2))])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_plain_versions_match_jax_above_panel_width(act, dtype, tols):
    """Above fused.TC_MAX_D (D = 1728, n 16, F 64), where the 16-bit
    kernels stream T(ln) through the product: the port's plain forward and
    backward (what chip_smoke.py holds those kernels against) against
    JAX's _fwd_kernel / _bwd_kernel in interpret mode, y and all five
    gradients, with the forward and gradient tolerances above. JAX's
    ``ln_matmul`` gates these shapes off the TPU (D and F multiples of
    128), so its kernels are called as its VJP calls them, with y's
    cotangent dy in y's dtype and the gradients cast as it casts them."""
    assert 1728 > fused.TC_MAX_D
    arrs = _inputs(4, 16, 1728, 64)
    x, gamma, beta, w, bias, dy = arrs
    jdt = DTYPES[dtype][0]
    jx, jw, jbias = (jnp.asarray(a, jdt) for a in (x, w, bias))
    jg, jb = jnp.asarray(gamma), jnp.asarray(beta)
    want_y = np.asarray(jfused._run_fwd(jx, jg, jb, jw, jbias, EPS, act, 128,
                                        True).astype(jnp.float32))
    dx, dw, dbias, dg, db = jfused._run_bwd(jx, jg, jb, jw, jbias,
                                            jnp.asarray(dy, jdt), EPS, act,
                                            128, True)
    # dx in x's dtype, dgamma and dbeta in fp32 (gamma's), dw and dbias
    # in w's and bias's
    want = [np.asarray(a.astype(jnp.float32)) for a in
            (dx, dg, db, dw.astype(jdt), dbias.astype(jdt))]
    got_y, got = _port_side(arrs, dtype, act)
    assert np.abs(got_y - want_y).max() <= tols[0]
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got,
                          want):
        _close(g, w, tols[1], name)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_plain_backward_matches_jax_grad(act):
    """ln_matmul_bwd_reference called alone, in fp32 (the CUDA kernels'
    plain version), against jax.grad of the JAX ln_matmul; and the
    helpers it shares with the JAX module."""
    x, gamma, beta, w, bias, dy = arrs = _inputs(3, 128, 128, 256)
    _, want = _jax_side(arrs, "float32", act)
    t = [torch.from_numpy(a) for a in (x, gamma, beta, w.T.copy(), bias,
                                       dy)]
    got = fused.ln_matmul_bwd_reference(*t, eps=EPS, activation=act)
    assert [g.dtype for g in got] == [torch.float32] * 5
    for name, g, wnt in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got,
                            want):
        g = g.numpy().T if name == "dw" else g.numpy()
        _close(g, wnt, 2e-4, name)
    # the two tanh implementations differ in their last bits, and 1 + tanh
    # cancels them into ~4e-6 absolute at z near -5 (values ~1e-5 there)
    z = np.linspace(-6, 6, 97, dtype=np.float32)
    for ours, theirs in ((fused._gelu_tanh, jfused._gelu_tanh),
                         (fused._gelu_tanh_grad, jfused._gelu_tanh_grad)):
        np.testing.assert_allclose(ours(torch.from_numpy(z)).numpy(),
                                   np.asarray(theirs(jnp.asarray(z))),
                                   rtol=0, atol=1e-5)
    for a, b in zip(fused._layernorm_rows(t[0], t[1], t[2], EPS),
                    jfused._layernorm_rows(jnp.asarray(x), gamma, beta,
                                           EPS)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_gate_and_walls():
    """Hopper's gate (D and F multiples of 8, any rows), not the TPU's
    (multiples of 128, >= 128-row blocks); shapes it refuses raise on the
    CPU too, as do bad shapes, activations and devices."""
    assert fused.ln_matmul_ok(1, 8, 8) and fused.ln_matmul_ok(300, 136, 200)
    assert not jfused.ln_matmul_ok(300, 136, 200)
    assert not fused.ln_matmul_ok(300, 132, 200)
    assert not fused.ln_matmul_ok(0, 128, 128)
    x, g, b, w, bias = (torch.zeros(4, 12), torch.ones(12), torch.zeros(12),
                        torch.zeros(16, 12), torch.zeros(16))
    with pytest.raises(ValueError, match="ln_matmul_ok"):
        fused.ln_matmul(x, g, b, w, bias)
    x, g, b = torch.zeros(4, 16), torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="shapes"):
        fused.ln_matmul(x, g, b, torch.zeros(16, 8), bias)
    with pytest.raises(ValueError, match="activation"):
        fused.ln_matmul(x, g, b, torch.zeros(16, 16), bias,
                        activation="relu")
    m = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused.ln_matmul(m, g.to("meta"), b.to("meta"),
                        torch.zeros(16, 16, device="meta"),
                        bias.to("meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA call whose kernels cannot be built raises; nothing falls back
    to the plain versions."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_ln")
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the GPT's fused_ln path
# ---------------------------------------------------------------------------

SMALL = dict(hidden_size=128, num_layers=2, num_heads=2, max_seq_len=128,
             vocab_size=512)


class _Count:
    """Counts calls of a function swapped in with monkeypatch, and the
    activation each asked for."""

    def __init__(self, monkeypatch, owner, name):
        self.fn = getattr(owner, name)
        self.acts = []
        monkeypatch.setattr(owner, name, self)

    def __call__(self, *a, **k):
        self.acts.append(k.get("activation"))
        return self.fn(*a, **k)


@pytest.mark.parametrize("mode", ["yes", "QKV", 1, 0, "both"])
def test_unknown_fused_ln_value_raises_as_in_jax(mode):
    with pytest.raises(ValueError, match="unknown fused_ln value"):
        make_gpt("tiny", fused_ln=mode)
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, fused_ln=mode)
    with pytest.raises(ValueError, match="unknown fused_ln value"):
        jm.init(jax.random.PRNGKey(0),
                {"input_ids": np.zeros((1, 8), np.int32)})


@pytest.mark.parametrize("mode,sites", [
    (True, {"qkv", "mlp"}), ("qkv", {"qkv"}), ("mlp", {"mlp"}),
    ("auto", set()), (False, set()), (None, set())])
def test_sites_fused_on_the_cpu(mode, sites, monkeypatch):
    """"qkv" / "mlp" fuse only their site (the plain forward runs once per
    layer with that site's activation), True both; "auto" is both sites on
    a CUDA input and none on the CPU; each mode gives the unfused model's
    loss."""
    ref = _Count(monkeypatch, fused, "ln_matmul_reference")
    torch.manual_seed(0)
    ids = torch.randint(0, 512, (2, 16))
    losses = []
    for m in (False, mode):
        model, cfg = make_gpt("tiny", dtype=torch.float32, fused_ln=m)
        model.load_state_dict(deepspeed_tpu_torch.models.init_gpt_params(
            cfg, seed=0))
        x = torch.zeros(2, 16, cfg.hidden_size)
        assert tgpt._use_fused_ln(cfg, x) == (sites if m is mode else
                                              set())
        losses.append(float(model(ids)["loss"].detach()))
    want = {"qkv": None, "mlp": "gelu"}
    assert sorted(ref.acts, key=str) == sorted(
        [want[s] for s in sites] * 2, key=str)
    assert abs(losses[1] - losses[0]) <= 1e-5 * losses[0]
    if mode == "auto":
        # on a CUDA input "auto" asks for both sites
        assert tgpt._fused_ln_sites("auto") == ("qkv", "mlp")


def test_cache_forms_fuse_too(monkeypatch):
    """The sites fuse in every forward form, as in JAX: ``generate`` (a
    dense-cache prefill, then decode steps of one token) and a paged
    serving trace give the unfused model's tokens, fp32."""
    ref = _Count(monkeypatch, fused, "ln_matmul_reference")
    cfg = make_gpt("tiny")[1]
    sd = deepspeed_tpu_torch.models.init_gpt_params(cfg, seed=3)
    prompt = np.array([[5, 9, 2, 7, 1]])
    toks = {}
    for mode in (False, True):
        model, _ = make_gpt("tiny", dtype=torch.float32, fused_ln=mode)
        eng = deepspeed_tpu_torch.init_inference(
            model, params=sd, dtype=torch.float32, device="cpu")
        srv = deepspeed_tpu_torch.init_serving(
            make_gpt("tiny", dtype=torch.float32, fused_ln=mode)[0],
            params=sd, dtype=torch.float32, device="cpu",
            config={"serving": {"max_batch_size": 2, "kv_block_size": 4,
                                "kv_num_blocks": 16}})
        rid = srv.submit([3, 1, 4, 1, 5], 4)
        toks[mode] = (np.asarray(eng.generate(prompt, max_new_tokens=4)),
                      srv.run_until_complete()[rid]["tokens"])
        if not mode:
            assert not ref.acts
    assert len(ref.acts) >= 2 * 2 * 4     # 2 sites x 2 layers x 4 steps
    np.testing.assert_array_equal(toks[True][0], toks[False][0])
    assert toks[True][1] == toks[False][1]


def test_gpt_loss_and_grads_match_jax(monkeypatch):
    """GPT with hidden 128, 2 layers, 2 heads, seq 128, batch 2, fp32,
    ``fused_ln=True`` in both packages on the same weights
    (``init_flax_gpt_params`` through ``models/convert.py``)."""
    tref = _Count(monkeypatch, fused, "ln_matmul_reference")
    jcall = _Count(monkeypatch, jfused, "ln_matmul")
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                         fused_ln=True, **SMALL)
    tm, cfg = make_gpt("tiny", dtype=torch.float32, fused_ln=True, **SMALL)
    tree = init_flax_gpt_params(cfg, seed=5)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 512, (2, 128), dtype=np.int32)

    def jloss(p):
        return jm.apply({"params": p}, {"input_ids": ids},
                        deterministic=True)["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tm.load_state_dict(gpt_params_from_flax(tree))
    out = tm(torch.from_numpy(ids).long())
    out["loss"].backward()
    assert jcall.acts.count(None) == 2 and jcall.acts.count("gelu") == 2
    assert tref.acts.count(None) == 2 and tref.acts.count("gelu") == 2
    assert abs(float(out["loss"].detach()) - float(want)) <= \
        1e-5 * float(want)
    wg = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in tm.named_parameters():
        w = wg[k].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 5e-4 * max(
            np.abs(w).max(), 1e-3), k


def test_engine_training_matches_jax(monkeypatch):
    """``initialize`` -> 2 ``train_batch`` steps of the fused GPT in both
    packages: micro 2 x seq 64 (128 rows, which the JAX gate fuses), GAS
    1, Adam at bench_gpt2's lr 1e-4 (eps 1e-6, see
    tests/test_torch_engine.py), ZeRO 2, fp32. At lr 1e-3 one element,
    wte[6, 7], ends 2.6e-5 apart (5.8e-6 with both models unfused): its
    first-step gradient is 9.7e-8 against a median |g| of 1.1e-3, so
    Adam's step lr g / (|g| + eps) is a ratio of rounding-level numbers
    and lr sets how far it moves."""
    tref = _Count(monkeypatch, fused, "ln_matmul_reference")
    jcall = _Count(monkeypatch, jfused, "ln_matmul")
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                                    "eps": 1e-6}},
           "zero_optimization": {"stage": 2}}
    rng = np.random.default_rng(7)
    batches = [{"input_ids": rng.integers(0, 512, (1, 2, 64),
                                          dtype=np.int32)}
               for _ in range(2)]
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                         fused_ln=True, **SMALL)
    tm, tcfg = make_gpt("tiny", dtype=torch.float32, fused_ln=True, **SMALL)
    tree = init_flax_gpt_params(tcfg, seed=9)
    sd = gpt_params_from_flax(tree)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, params=jax.tree_util.tree_map(jnp.asarray, tree),
        config=DeepSpeedTPUConfig(cfg, world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))
    jl = [float(jeng.train_batch(b)) for b in batches]
    jp = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jeng.state.params))
    teng, *_ = deepspeed_tpu_torch.initialize(model=tm, params=sd,
                                              config=cfg, device="cpu")
    tl = [float(teng.train_batch(b)) for b in batches]
    assert jcall.acts.count("gelu") >= 2 and jcall.acts.count(None) >= 2
    # 2 steps x 2 layers x (qkv, mlp)
    assert tref.acts.count(None) == 4 and tref.acts.count("gelu") == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[1] != tl[0]
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jp[k], atol=1e-5, rtol=0,
                                   err_msg=k)
