"""The port at the codebook sizes and sentence lengths beyond its card
kernels' one-pass limits, vs the JAX package on the CPU, in f32.

On the card these shapes take the general paths: the VQ forward's streamed
codebook and the codebook gradient's code chunks (``csrc/vq_fwd.cu``,
``csrc/vq_bwd.cu``) above ~37 codes at D 768, and the 64-row attention
tiles of ``csrc/attention_long.cu`` above 32 tokens. Here every wrapper
takes its plain version (CPU tensors), held against JAX's Pallas kernels in
interpret mode on the same seeded numpy inputs:

- the VQ bottleneck at n_e 38, 64 and 512 (D 64) against
  ``fused_vector_quantize``, with two codes equal so that rows near them tie
  exactly (the first minimum wins on both sides): indices, counts and
  one-hot equal; z_q, sum_z, loss and perplexity to rtol 1e-5; dz and the
  codebook gradient (``codebook_grad``) of ``loss * a + sum(z_q * w)`` to
  rtol 1e-5, atol 1e-7 (the bars of ``tests/test_torch_vq.py``);
- ``fused_sdpa`` (#11 / #12) at S 40 (self causal and padded, cross over 45
  padded keys, dropout 0.1) against ``sdpa_pallas.fused_sdpa``: the
  forward at atol 1e-5, dq / dk / dv at atol 2e-5; ``fused_mha`` (#13) at S
  40, masked and causal, the same bars (``tests/test_torch_sdpa.py``), and
  at 64 tokens, causal, with a fully masked sentence and one whose first
  keys are masked: the rows that the card's causal tile skip must leave
  near uniform over every key;
- one fused decoder layer at S 40 (its attention #1a forward and #3 / #4
  backward: causal padded self-attention, padded cross-attention over 45
  rows; dropout 0.1 on the probabilities and the hidden sites) against
  ``jax.vjp`` of ``fused_bert_layer``: the output and every gradient to
  max|port - jax| / max|jax| <= 1e-4 (the bar of
  ``tests/test_torch_layer_train.py``);
- one training step of a two-layer Shelgon3-VQ at S 40 with 64 codes,
  ``fused_layer="on"`` on both sides (JAX: the Pallas layer kernels in
  interpret mode), dropout off (the step's seeds differ between the
  frameworks; the layer case above holds the hash dropout): the scalar stats
  to rtol 1e-5, the VQ codes and ``recon_ids`` exactly, every gradient leaf
  to rel 1e-4 (the bars of ``tests/test_torch_train.py``).

One worker: ~67 s (``--durations``), the two-layer step ~25 s of it,
``fused_mha`` at 64 tokens ~10 s, at 40 tokens and the decoder layer ~7 s
each, most of it JAX compiling its interpret-mode kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.attention_pallas import fused_mha as jax_mha
from kindergarten_vq_vae_tpu.ops.layer_pallas import LayerGeom as JaxGeom
from kindergarten_vq_vae_tpu.ops.layer_pallas import fused_bert_layer as jax_fused_layer
from kindergarten_vq_vae_tpu.ops.sdpa_pallas import fused_sdpa as jax_sdpa
from kindergarten_vq_vae_tpu.ops.vq_pallas import fused_vector_quantize as jax_fused_vq
from kindergarten_vq_vae_tpu.train.config import DataConfig, ModelConfig, OptimConfig, RunConfig
from kindergarten_vq_vae_tpu.train.variants import init_params, make_loss_fn
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.ops.attention import fused_mha
from kindergarten_vq_vae_torch.ops.layer import (
    DEC_WEIGHTS,
    LayerGeom,
    fused_bert_layer,
)
from kindergarten_vq_vae_torch.ops.sdpa import fused_sdpa
from kindergarten_vq_vae_torch.ops.vq import codebook_grad
from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel
from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

H, NH, F = 64, 4, 128
S, SK = 40, 45  # past the short attention kernels' 32 rows: one 64-row tile each
SEED = -123456789
REL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _padded(rng, b, n, low=1):
    return (np.arange(n)[None] < rng.integers(low, n + 1, b)[:, None]).astype(np.int32)


# ------------------------------------------------------------------ VQ


def _vq_case(n_e, seed, d=64, rows=36):
    """Rows near random codes; code 1 equals code n_e - 3, and a quarter of
    the rows sit near them (an exact tie: the first minimum is code 1)."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(-1.0 / n_e, 1.0 / n_e, size=(n_e, d)).astype(np.float32)
    e[n_e - 3] = e[1]
    near = rng.integers(0, n_e, rows)
    near[::4] = 1
    z = (e[near] + 1e-3 * rng.normal(size=(rows, d))).astype(np.float32)
    w = rng.normal(size=(rows, d)).astype(np.float32)
    return z.reshape(3, rows // 3, d), e, w.reshape(3, rows // 3, d)


@pytest.mark.parametrize("n_e", [38, 64, 512])
def test_vq_at_large_codebooks_matches_jax(n_e):
    z, e, w = _vq_case(n_e, n_e)
    beta, a = 0.69, 3.0

    def f(z_, e_):
        out = jax_fused_vq(z_, e_, beta)
        return out.loss * a + jnp.sum(out.z_q * w), out

    (_, want), (dz_want, de_want) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(e))
    zt, et = _t(z, True), _t(e, True)
    before = vector_quantize_kernel.launches, codebook_grad.launches
    got = vector_quantize_kernel(zt, et, beta)
    (got.loss * a + (got.z_q * torch.from_numpy(w)).sum()).backward()
    assert (vector_quantize_kernel.launches, codebook_grad.launches) == before

    idx = got.indices.reshape(-1).numpy()
    assert (idx[::4] == 1).all() and n_e - 3 not in idx  # the tie: the first minimum
    np.testing.assert_array_equal(idx, np.asarray(want.indices).reshape(-1))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.one_hot.numpy(), np.asarray(want.one_hot))
    np.testing.assert_allclose(got.z_q.detach().numpy(), np.asarray(want.z_q), rtol=1e-5)
    np.testing.assert_allclose(got.sum_z.numpy(), np.asarray(want.sum_z), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.loss.detach()), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(float(got.perplexity), float(want.perplexity), rtol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(dz_want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(de_want), rtol=1e-5, atol=1e-7)
    assert (et.grad[n_e - 3] == 0).all()


# ------------------------------------------------------------------ attention


def _jax_vjp(f, q, k, v, w):
    """f(q, k, v) and its vjp at w, jitted (the interpreted kernels run
    compiled)."""
    def both(q_, k_, v_, w_):
        out, vjp = jax.vjp(f, q_, k_, v_)
        return out, vjp(w_)

    return jax.jit(both)(*map(jnp.asarray, (q, k, v, w)))


def _sdpa_inputs(b, sq, sk, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, H)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, H)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(b, sq, H)).astype(np.float32)
    return q, k, v, _padded(rng, b, sk) if masked else None, w


@pytest.mark.parametrize("sq,sk,causal,masked,rate", [
    (S, S, True, True, 0.1),      # self, causal and padded
    (S, S, False, False, 0.0),
    (S, SK, False, True, 0.1),    # cross over padded keys
])
def test_fused_sdpa_long_matches_jax(sq, sk, causal, masked, rate):
    q, k, v, mask, w = _sdpa_inputs(3, sq, sk, masked)
    m = None if mask is None else jnp.asarray(mask)
    seed = jnp.asarray([SEED], jnp.int32)
    want, want_grads = _jax_vjp(lambda q_, k_, v_: jax_sdpa(q_, k_, v_, m, seed, NH, causal, rate,
                                                          2), q, k, v, w)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    got = fused_sdpa(tq, tk, tv, _t(mask), SEED, NH, causal, rate, cross=sq != sk)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5, err_msg=f"d{name}")


def test_fused_mha_long_matches_jax():
    causal = True
    q, k, v, mask, w = _sdpa_inputs(2, S, S, True, seed=1)
    want, want_grads = _jax_vjp(lambda q_, k_, v_: jax_mha(q_, k_, v_, jnp.asarray(mask), NH,
                                                         causal, 2), q, k, v, w)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    got = fused_mha(tq, tk, tv, _t(mask), NH, causal)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5, err_msg=f"d{name}")


def test_fused_mha_at_64_tokens_with_masked_rows_matches_jax():
    """#13 at 64 tokens (one full 64-row tile: the card's causal tile skip
    is bounded by it), causal, with a fully masked sentence (every row near
    uniform over all 64 keys, j > i included) and one whose first three keys
    are masked (its rows 0-2 see no key at or before them)."""
    rng = np.random.default_rng(7)
    b, s = 3, 64
    q, k, v, w = (rng.normal(size=(b, s, H)).astype(np.float32) for _ in range(4))
    mask = _padded(rng, b, s, low=8)
    mask[1] = 0
    mask[2, :3] = 0
    want, want_grads = _jax_vjp(lambda q_, k_, v_: jax_mha(q_, k_, v_, jnp.asarray(mask), NH,
                                                         True, 2), q, k, v, w)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    got = fused_mha(tq, tk, tv, _t(mask), NH, True)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got[1].detach().numpy(), np.broadcast_to(v[1].mean(0), (s, H)),
                               atol=1e-5)
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5, err_msg=f"d{name}")


def test_fused_decoder_layer_long_matches_jax_vjp():
    """One decoder layer: causal padded self-attention, padded cross-attention
    over 45 encoder rows, dropout 0.1 on the probabilities and the hidden
    sites, the output and every gradient against ``jax.vjp``."""
    rng = np.random.default_rng(2)
    b, seed = 3, -123457
    x = rng.normal(size=(b, S, H)).astype(np.float32)
    enc = rng.normal(size=(b, SK, H)).astype(np.float32)
    smask, cmask = _padded(rng, b, S), _padded(rng, b, SK)
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=True, has_cross=True,
                     eps=1e-12, gelu_exact=True, attn_rate=0.1, hid_rate=0.1)
    shapes = geom.weight_shapes()
    ws = [((1.0 if n.startswith("g") else 0.0) + rng.normal(scale=0.1, size=shapes[n]))
          .astype(np.float32) for n in DEC_WEIGHTS]
    gy = rng.normal(size=(b, S, H)).astype(np.float32)
    jgeom = JaxGeom(num_heads=NH, head_dim=H // NH, s_q=S, s_k=SK, intermediate=F, causal=True,
                    has_cross=True, attn_rate=0.1, hid_rate=0.1, eps=1e-12, gelu_exact=True,
                    block_b_fwd=2, block_b_bwd=2)

    def f(x_, enc_, *w):
        return jax_fused_layer(jgeom, x_, enc_, jnp.asarray(smask), jnp.asarray(cmask),
                               jnp.asarray([seed], jnp.int32), None, *w)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(enc), *map(jnp.asarray, ws))
    wgrads = vjp(jnp.asarray(gy))
    xt, enct, wt = _t(x, True), _t(enc, True), [_t(w, True) for w in ws]
    out = fused_bert_layer(geom, xt, enct, _t(smask), _t(cmask), wt, seed=seed)
    out.backward(torch.from_numpy(gy))
    assert _rel(out.detach(), want) <= REL
    assert _rel(xt.grad, wgrads[0]) <= REL
    assert _rel(enct.grad, wgrads[1]) <= REL
    for n, w, g in zip(DEC_WEIGHTS, wt, wgrads[2:]):
        assert _rel(w.grad, g) <= REL, n


# ------------------------------------------------------------------ the step


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def test_shelgon3_step_at_40_tokens_and_64_codes_matches_jax():
    b, vocab = 2, 211
    cfg = RunConfig(
        model=ModelConfig(model_name="shelgon3", vocab_size=vocab, hidden_size=H, num_layers=2,
                          num_heads=NH, intermediate_size=F, compute_dtype="float32",
                          vq_e_dim=H, enc_out_size=H, vq_n_e=64, fused_layer="on"),
        data=DataConfig(batch_size=b, tokenized_sentence_max_length=S),
        optim=OptimConfig(lr=1e-3))
    params = init_params(cfg, jax.random.key(0))
    tcfg = TorchRunConfig.from_flat_dict(cfg.get_config())
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    state = init_train_state(tcfg, model)
    step = make_train_step(tcfg, "cpu", torch.Generator().manual_seed(0), deterministic=True)

    rng = np.random.default_rng(3)
    mask = _padded(rng, b, S, low=3)
    ids = (rng.integers(1, vocab, (b, S)) * mask).astype(np.int32)
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
