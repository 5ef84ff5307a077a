"""The port at the hidden widths and head sizes past its card kernels' first
limits, vs the JAX package on the CPU, in f32.

On the card these shapes take the wide paths: rows of more than 1,024
columns the block-a-row LayerNorm kernels of ``csrc/layernorm.cu``, and
heads of more than 128 columns the 64-column chunks of
``csrc/attention_long.cu``'s wide kernels, at every sequence length. Here every wrapper
takes its plain version (CPU tensors), held against JAX's Pallas kernels in
interpret mode (or its plain LayerNorm functions) on the same seeded numpy
inputs:

- one fused encoder and one fused decoder layer (causal padded
  self-attention, padded cross-attention, dropout 0.1 on the probabilities
  and the hidden sites) at H 1,088 (17 heads x 64: LayerNorm rows past
  1,024) and at H 384 with 2 heads (head_dim 192), the output and every
  gradient against ``jax.vjp`` of ``fused_bert_layer``: max|port - jax| /
  max|jax| <= ``REL`` (1e-4, the bar of ``tests/test_torch_long.py``);
- ``fused_sdpa`` (#11 / #12; self causal padded, cross over padded keys,
  dropout 0.1) and ``fused_mha`` (#13, with a fully masked sentence) at
  head_dim 192 and 384 against JAX's: the forward within ``ATTN_FWD``
  (1e-5) absolute, dq / dk / dv within ``ATTN_GRAD`` (2e-5; the bars of
  ``tests/test_torch_sdpa.py``);
- the plain residual + LayerNorm and its backward (dgamma / dbeta / dbias)
  at N 1,600 against ``_ln_fwd`` / ``_ln_recover_yhat`` / ``_ln_bwd``, with
  the keep mask of ``_keep_2d`` held bit for bit: every output within
  ``LN_REL`` (1e-5) of its largest magnitude (the bar of
  ``tests/test_torch_layernorm.py``);
- one training step of a Shelgon3-VQ at H 1,040 with 8 heads (head_dim 130:
  past both limits), 1 + 1 layers, a 97-word vocabulary and batch 2,
  ``fused_layer="on"`` on both sides, dropout off (the frameworks' step
  seeds differ; the layer case holds the hash dropout): the scalar stats to
  rtol 1e-5, the codes and ``recon_ids`` exactly, every gradient leaf
  within ``REL``;
- the card wrappers' guards, which run on any device before a launch, take
  H 1,032 / 1,600 and head_dim 130 / 192 / 768, and the backward's
  statistics scratch is allocated past 32 queries or keys only, at any
  head_dim; #11 / #12 on either side of the routes' boundaries (32 / 33
  tokens, head_dim 128 / 129);
- the weight bridge (``ckpt/bridge.py``) and the run config at gpt2-large's
  widths (GPT-2 decoder) and at head_dim 192 (BERT decoder): JAX's
  parameter tree loads into the port's model strictly and comes back bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.attention_pallas import fused_mha as jax_mha
from kindergarten_vq_vae_tpu.ops.layer_pallas import LayerGeom as JaxGeom
from kindergarten_vq_vae_tpu.ops.layer_pallas import (
    _keep_2d,
    _ln_bwd,
    _ln_fwd,
    _ln_recover_yhat,
)
from kindergarten_vq_vae_tpu.ops.layer_pallas import fused_bert_layer as jax_fused_layer
from kindergarten_vq_vae_tpu.ops.sdpa_pallas import fused_sdpa as jax_sdpa
from kindergarten_vq_vae_tpu.train.config import DataConfig, ModelConfig, OptimConfig, RunConfig
from kindergarten_vq_vae_tpu.train.variants import init_params, make_loss_fn
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax, params_to_jax
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.ops.attention import fused_mha
from kindergarten_vq_vae_torch.ops.dropout import OP_MLP_OUT, hidden_keep
from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    ENC_WEIGHTS,
    LayerGeom,
    _attention_args,
    _check_layer_inputs,
    _check_ln_width,
    fused_bert_layer,
    layernorm_backward,
    long_stats,
    residual_layernorm,
)
from kindergarten_vq_vae_torch.ops.sdpa import _check_kernel_inputs, fused_sdpa
from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

SEED = -123456789
REL, LN_REL, ATTN_FWD, ATTN_GRAD = 1e-4, 1e-5, 1e-5, 2e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _padded(rng, b, n, low=1):
    return (np.arange(n)[None] < rng.integers(low, n + 1, b)[:, None]).astype(np.int32)


# ------------------------------------------------------------------ the layer


@pytest.mark.parametrize("decoder", [False, True], ids=["encoder", "decoder"])
@pytest.mark.parametrize("H,NH", [(1088, 17), (384, 2)], ids=["H1088", "hd192"])
def test_fused_layer_wide_matches_jax_vjp(H, NH, decoder):
    """One layer at a LayerNorm width past 1,024 or a head_dim past 128:
    padded masks (causal self-attention and a padded cross-attention in the
    decoder), dropout 0.1 at every site, the output and every gradient
    against ``jax.vjp``."""
    rng = np.random.default_rng(H + decoder)
    b, s, sk, F, seed = 2, 6, 5, 64, -123457
    x = rng.normal(size=(b, s, H)).astype(np.float32)
    enc = rng.normal(size=(b, sk, H)).astype(np.float32) if decoder else None
    smask = _padded(rng, b, s)
    cmask = _padded(rng, b, sk) if decoder else None
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True, attn_rate=0.1, hid_rate=0.1)
    names = DEC_WEIGHTS if decoder else ENC_WEIGHTS
    shapes = geom.weight_shapes()
    ws = [((1.0 if n.startswith("g") else 0.0) + rng.normal(scale=0.1, size=shapes[n]))
          .astype(np.float32) for n in names]
    gy = rng.normal(size=(b, s, H)).astype(np.float32)
    jgeom = JaxGeom(num_heads=NH, head_dim=H // NH, s_q=s, s_k=sk if decoder else s,
                    intermediate=F, causal=decoder, has_cross=decoder, attn_rate=0.1,
                    hid_rate=0.1, eps=1e-12, gelu_exact=True, block_b_fwd=2, block_b_bwd=2)
    jcmask = None if cmask is None else jnp.asarray(cmask)

    def f(x_, enc_, *w):
        return jax_fused_layer(jgeom, x_, enc_, jnp.asarray(smask), jcmask,
                               jnp.asarray([seed], jnp.int32), None, *w)

    primals = (jnp.asarray(x), None if enc is None else jnp.asarray(enc), *map(jnp.asarray, ws))
    want, vjp = jax.vjp(f, *primals)
    wgrads = vjp(jnp.asarray(gy))
    xt, enct, wt = _t(x, True), _t(enc, True), [_t(w, True) for w in ws]
    out = fused_bert_layer(geom, xt, enct, _t(smask), _t(cmask), wt, seed=seed)
    out.backward(torch.from_numpy(gy))
    assert _rel(out.detach(), want) <= REL
    assert _rel(xt.grad, wgrads[0]) <= REL
    if decoder:
        assert _rel(enct.grad, wgrads[1]) <= REL
    for n, w, g in zip(names, wt, wgrads[2:]):
        assert _rel(w.grad, g) <= REL, n


# ------------------------------------------------------------------ attention


def _jax_vjp(f, q, k, v, w):
    """f(q, k, v) and its vjp at w, jitted (the interpreted kernels run
    compiled)."""
    def both(q_, k_, v_, w_):
        out, vjp = jax.vjp(f, q_, k_, v_)
        return out, vjp(w_)

    return jax.jit(both)(*map(jnp.asarray, (q, k, v, w)))


@pytest.mark.parametrize("sq,sk,causal", [(7, 7, True), (6, 9, False)], ids=["self", "cross"])
@pytest.mark.parametrize("hd", [192, 384])
def test_fused_sdpa_wide_head_matches_jax(hd, sq, sk, causal):
    _sdpa_matches_jax(hd, sq, sk, causal)


@pytest.mark.parametrize("sq,sk,causal", [(32, 32, True), (33, 33, True), (32, 33, False)],
                         ids=["32", "33", "32-33"])
@pytest.mark.parametrize("hd", [128, 129])
def test_fused_sdpa_at_route_boundaries_matches_jax(hd, sq, sk, causal):
    """#11 / #12 on either side of the card's routes (32 / 33 tokens: a warp
    a (sentence, head) or 64-row tiles; head_dim 128 / 129: the 128-column
    kernels or the wide ones' 64-column chunks), and the backward's
    statistics scratch, which exists past 32 queries or keys whatever the
    head_dim."""
    assert (long_stats(3, 2, sq, sk, "cpu") is None) == (max(sq, sk) <= 32)
    _sdpa_matches_jax(hd, sq, sk, causal)


def _sdpa_matches_jax(hd, sq, sk, causal):
    rng = np.random.default_rng(hd + sk)
    b, nh = 3, 2
    H = nh * hd
    q, w = (rng.normal(size=(b, sq, H)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, sk, H)).astype(np.float32) for _ in range(2))
    mask = _padded(rng, b, sk)
    seed = jnp.asarray([SEED], jnp.int32)
    want, want_grads = _jax_vjp(lambda q_, k_, v_: jax_sdpa(q_, k_, v_, jnp.asarray(mask), seed,
                                                          nh, causal, 0.1, 2), q, k, v, w)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    got = fused_sdpa(tq, tk, tv, _t(mask), SEED, nh, causal, 0.1, cross=not causal)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_FWD)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATTN_GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("hd", [192, 384])
def test_fused_mha_wide_head_matches_jax(hd):
    """#13, causal, with a fully masked sentence (its rows near uniform over
    every key)."""
    rng = np.random.default_rng(hd + 1)
    b, s, nh = 3, 8, 2
    H = nh * hd
    q, k, v, w = (rng.normal(size=(b, s, H)).astype(np.float32) for _ in range(4))
    mask = _padded(rng, b, s, low=2)
    mask[1] = 0
    want, want_grads = _jax_vjp(lambda q_, k_, v_: jax_mha(q_, k_, v_, jnp.asarray(mask), nh,
                                                         True, 2), q, k, v, w)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    got = fused_mha(tq, tk, tv, _t(mask), nh, True)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_FWD)
    np.testing.assert_allclose(got[1].detach().numpy(), np.broadcast_to(v[1].mean(0), (s, H)),
                               atol=ATTN_FWD)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATTN_GRAD,
                                   err_msg=f"d{name}")


# ------------------------------------------------------------------ LayerNorm


@jax.jit
def _jax_ln(x, a, gamma, beta, gy, keep):
    """_ln_fwd of x + a * keep, then _ln_bwd from the stored output as the
    layer backward recovers it, with the three column sums."""
    out, _, inv = _ln_fwd(x + a * keep, gamma, beta, 1e-12, jnp.float32)
    yhat = _ln_recover_yhat(out, gamma, beta)
    dr = _ln_bwd(gy, yhat, inv, gamma)
    da = dr * keep
    return (out, inv[:, 0], dr, da, jnp.sum(gy * yhat, axis=0), jnp.sum(gy, axis=0),
            jnp.sum(da, axis=0))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layernorm_pair_at_1600_matches_jax(rate):
    rows, N = 33, 1600
    rng = np.random.default_rng(N)
    x = rng.normal(size=(rows, N)).astype(np.float32)
    a = (0.5 * rng.normal(size=(rows, N)) + 0.2).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=N)).astype(np.float32)
    gamma[1027] = 0.0  # a dead column past the warp-a-row width
    beta = (0.1 * rng.normal(size=N)).astype(np.float32)
    gy = rng.normal(size=(rows, N)).astype(np.float32)
    keep = np.ones((rows, N), np.float32)
    if rate:
        keep = np.asarray(_keep_2d(jnp.int32(SEED), jnp.int32(0), OP_MLP_OUT, rows, N, rate))
        np.testing.assert_array_equal(hidden_keep(SEED, OP_MLP_OUT, rows, N, rate).numpy(), keep)
    want = _jax_ln(x, a, gamma, beta, gy, keep)
    g_t, b_t = torch.from_numpy(gamma), torch.from_numpy(beta)
    out, inv = residual_layernorm(torch.from_numpy(x), torch.from_numpy(a), g_t, b_t, 1e-12, SEED,
                                  OP_MLP_OUT, rate)
    got = (out, inv, *layernorm_backward(torch.from_numpy(gy), out, inv, g_t, b_t, SEED,
                                         OP_MLP_OUT, rate))
    names = ("out", "inv", "dr", "da", "dgamma", "dbeta", "dbias")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == np.shape(w), name
        assert _rel(g, w) <= LN_REL, name
    assert got[4][1027] == 0.0  # gamma 0: yhat 0, no dgamma


# ------------------------------------------------------------------ the step


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def test_shelgon3_step_at_width_1040_head_dim_130_matches_jax():
    b, s, vocab, H, NH = 2, 6, 97, 1040, 8
    cfg = RunConfig(
        model=ModelConfig(model_name="shelgon3", vocab_size=vocab, hidden_size=H, num_layers=1,
                          num_heads=NH, intermediate_size=64, compute_dtype="float32",
                          vq_e_dim=H, enc_out_size=H, vq_n_e=9, fused_layer="on"),
        data=DataConfig(batch_size=b, tokenized_sentence_max_length=s),
        optim=OptimConfig(lr=1e-3))
    params = init_params(cfg, jax.random.key(0))
    tcfg = TorchRunConfig.from_flat_dict(cfg.get_config())
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    state = init_train_state(tcfg, model)
    step = make_train_step(tcfg, "cpu", torch.Generator().manual_seed(0), deterministic=True)

    rng = np.random.default_rng(3)
    mask = _padded(rng, b, s, low=3)
    ids = (rng.integers(1, vocab, (b, s)) * mask).astype(np.int32)
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "n_valid": jnp.int32(b)}
    tbatch = {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask),
              "n_valid": b}
    rngs = {k: jax.random.key(1) for k in ("dropout", "gumbel", "perturb")}
    grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(cfg, "train"), has_aux=True),
                      static_argnums=3)
    (_, jaux), grads = grad_fn(params, jbatch, rngs, True)
    state, aux = step(state, tbatch)

    np.testing.assert_array_equal(aux["min_encoding_indices"].numpy(),
                                  np.asarray(jaux["min_encoding_indices"]))
    np.testing.assert_array_equal(aux["recon_ids"].numpy(), np.asarray(jaux["recon_ids"]))
    for k in ("loss_recon", "loss_full", "metric_acc", "loss_vq", "metric_perp"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    tgrads = {n: p.grad for n, p in model.named_parameters()}
    for name, g in _flat(jax.device_get(grads)):
        got = np.zeros_like(g) if tgrads[name] is None else tgrads[name].numpy()
        assert _rel(got, g) <= REL, name


# ------------------------------------------------------------------ the guards


@pytest.mark.parametrize("H,NH", [(1032, 8), (1600, 25), (1040, 8), (384, 2), (768, 1)])
def test_guards_take_wide_rows_and_heads(H, NH):
    """The checks that a card call runs before its launch take every width
    that is a multiple of 8 and any head_dim; what they still refuse is the
    other kernels' conditions (a width not divisible by 8, a length past
    512)."""
    b, s = 2, 5
    x = torch.zeros(b, s, H)
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=64, causal=False,
                     has_cross=False, eps=1e-12, gelu_exact=True)
    shapes = geom.weight_shapes()
    ws = [torch.zeros(shapes[n]) for n in ENC_WEIGHTS]
    assert _check_layer_inputs(geom, x, None, None, None, ws) == s
    _check_ln_width(H, "residual_layernorm")
    assert _attention_args(torch.zeros(b, s, 3 * H), None, None, NH, 0.1, "attention") == (
        b, s, s, H)
    _check_kernel_inputs(x, x, x, None, NH, "sdpa_forward")
    assert long_stats(b, NH, s, s, "cpu") is None  # up to 32 tokens at any head_dim
    stats = long_stats(b, NH, s, 33, "cpu")
    assert stats.shape == (b * NH * s * 4,) and stats.dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of 8"):
        _check_ln_width(H + 4, "residual_layernorm")
    with pytest.raises(ValueError, match="sequences"):
        _check_kernel_inputs(torch.zeros(b, 513, H), x, x, None, NH, "sdpa_forward")


@pytest.mark.parametrize("H,NH,F,decoder", [(1280, 20, 5120, "gpt2"),
                                           (768, 4, 64, "bert-base-uncased")],
                         ids=["gpt2-large", "hd192"])
def test_bridge_and_configs_take_wide_geometries(H, NH, F, decoder):
    """The JAX parameter tree of a Shelgon3-VQ at gpt2-large's widths (n_embd
    1,280, 20 heads, n_inner 5,120, the GPT-2 decoder) and at bert-base's
    with 4 heads (head_dim 192, the BERT decoder), one layer a side and small
    vocabularies, crosses the weight bridge into the port's model built from
    the same run config, every leaf at its shape
    (``load_state_dict(strict=True)``), and comes back unchanged."""
    cfg = RunConfig(
        model=ModelConfig(model_name="shelgon3", vocab_size=97, hidden_size=H, num_layers=1,
                          num_heads=NH, intermediate_size=F, compute_dtype="float32",
                          vq_e_dim=H, enc_out_size=H, vq_n_e=9,
                          decoder_model_name=decoder, decoder_vocab_size=300),
        data=DataConfig(batch_size=2, tokenized_sentence_max_length=6))
    params = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.key(0)))
    model = build_model(TorchRunConfig.from_flat_dict(cfg.get_config()))
    model.load_state_dict(params_from_jax(params), strict=True)
    back = dict(_flat(params_to_jax(model)))
    for name, leaf in _flat(params):
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)
