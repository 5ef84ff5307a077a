"""The port's fused MLM-head + CE + argmax vs the JAX package's, on the CPU.

``ops/head_ce.fused_head_ce_loss`` (its plain versions: a CPU tensor never
reaches a kernel) against JAX ``ops/head_ce_pallas.fused_head_ce_loss``
(Pallas in interpret mode, tiles 32 x 64) at B, S, H, V = 4, 6, 32, 133 (a
ragged vocab edge) with a padded tail row, in both modes:

- f32: loss rtol 1e-5, ids exactly, the gradients of hidden, table and bias
  at rtol 2e-5, atol 1e-6 (the JAX package's own bar against its oracle,
  ``tests/test_head_ce.py:49-59``; both sides compute in f32 and differ only
  in summation order);
- bf16: the JAX package's bf16 bars (l.70-77): loss rtol 3e-4, at least 95%
  of the ids equal (a matmul in another order can move a logit by one bf16
  ulp and flip a near-tie), the table gradient within 3e-2 of its largest
  magnitude.

``make_loss_fn`` with ``fused_head_ce`` "store" / "flash" against "off" and
against JAX's ``value_and_grad(make_loss_fn)``, for Shelgon3 and Bagon, from
the same JAX initial weights: the stats to rel 1e-5, ids exactly, every
gradient leaf to max|port - jax| / max|jax| <= 1e-4 (the criterion of
``tests/test_torch_train.py``). ``_resolve_head_ce`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.ops.head_ce_pallas import fused_head_ce_loss as jax_head_ce
from kindergarten_vq_vae_tpu.train.config import DataConfig, ModelConfig, RunConfig
from kindergarten_vq_vae_tpu.train.variants import _resolve_head_ce as jax_resolve
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_tpu.train.variants import make_loss_fn as jax_make_loss_fn
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.ops.head_ce import fused_head_ce_loss, head_ce_bwd, head_ce_fwd
from kindergarten_vq_vae_torch.train.variants import _resolve_head_ce, make_loss_fn

B, S, H, V = 4, 6, 32, 133


def _data():
    rng = np.random.default_rng(0)
    hidden = (0.5 * rng.normal(size=(B, S, H))).astype(np.float32)
    table = (0.3 * rng.normal(size=(V, H))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(V,))).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    valid = (np.arange(B) < B - 1).astype(np.float32)  # a padded tail row
    return hidden, table, bias, tgt, valid


def _jax(mode, hidden, table, bias, tgt, valid):
    """JAX loss, ids and the gradients of hidden, table and bias."""
    def f(h, t, b):
        return jax_head_ce(h, t, b, jnp.asarray(tgt), jnp.asarray(valid), None, mode, 32, 64,
                           True)

    (loss, ids), vjp = jax.vjp(f, hidden, jnp.asarray(table), jnp.asarray(bias))
    grads = vjp((jnp.ones_like(loss), np.zeros(ids.shape, jax.dtypes.float0)))
    return loss, ids, grads


def _port(mode, hidden, table, bias, tgt, valid):
    h = hidden.detach().requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    before = head_ce_fwd.launches, head_ce_bwd.launches
    loss, ids = fused_head_ce_loss(h, t, b, torch.from_numpy(tgt), torch.from_numpy(valid),
                                   mode=mode)
    loss.backward()
    assert (head_ce_fwd.launches, head_ce_bwd.launches) == before  # CPU: the plain versions
    assert t.grad.dtype == torch.float32 and b.grad.dtype == torch.float32
    return loss.detach(), ids, (h.grad, t.grad, b.grad)


@pytest.mark.parametrize("mode", ["store", "flash"])
def test_fused_head_ce_matches_jax_f32(mode):
    hidden, table, bias, tgt, valid = _data()
    lj, ids_j, gj = _jax(mode, jnp.asarray(hidden), table, bias, tgt, valid)
    lp, ids_p, gp = _port(mode, torch.from_numpy(hidden), table, bias, tgt, valid)
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    assert ids_p.dtype == torch.int32 and ids_p.shape == (B, S)
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_j))
    for name, a, b in zip(("hidden", "table", "bias"), gp, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6, err_msg=name)
    assert (gp[0][B - 1] == 0).all()  # the padded row takes no gradient


@pytest.mark.parametrize("mode", ["store", "flash"])
def test_fused_head_ce_bf16_close_to_jax(mode):
    hidden, table, bias, tgt, valid = _data()
    lj, ids_j, gj = _jax(mode, jnp.asarray(hidden).astype(jnp.bfloat16), table, bias, tgt, valid)
    lp, ids_p, gp = _port(mode, torch.from_numpy(hidden).bfloat16(), table, bias, tgt, valid)
    np.testing.assert_allclose(float(lp), float(lj), rtol=3e-4)
    assert (ids_p.numpy() == np.asarray(ids_j)).mean() > 0.95
    scale = float(jnp.max(jnp.abs(gj[1]))) + 1e-9
    assert np.abs(gp[1].numpy() - np.asarray(gj[1])).max() / scale < 3e-2


def _cfg(model_name, fused_head_ce, **kw):
    model = ModelConfig(model_name=model_name, vocab_size=V, hidden_size=32, num_layers=1,
                        num_heads=2, intermediate_size=64, compute_dtype="float32", vq_e_dim=32,
                        enc_out_size=32, fused_head_ce=fused_head_ce, head_ce_block_r=16,
                        head_ce_block_v=64, **kw)
    return RunConfig(model=model, data=DataConfig(batch_size=4, tokenized_sentence_max_length=S))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


@pytest.mark.parametrize("model_name", ["shelgon3", "bagon"])
def test_make_loss_fn_fused_head_matches_off_and_jax(model_name):
    rng = np.random.default_rng(1)
    ids = rng.integers(1, V, (4, S)).astype(np.int32)
    mask = np.ones((4, S), np.int32)
    mask[1, 4:] = 0
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "n_valid": jnp.asarray(3, jnp.int32)}
    tbatch = {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask),
              "n_valid": 3}
    rngs = {k: jax.random.key(i) for i, k in enumerate(("dropout", "gumbel", "perturb"))}
    params = init_params(_cfg(model_name, "off"), jax.random.key(0))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    keys = ["loss_recon", "loss_full", "metric_acc"]
    outs = {}
    for mode in ("off", "store", "flash"):
        cfg = _cfg(model_name, mode)
        (_, jaux), jgrads = jax.value_and_grad(jax_make_loss_fn(cfg, "train"), has_aux=True)(
            params, jbatch, rngs, True)
        tcfg = TorchRunConfig.from_flat_dict(cfg.get_config())
        model = build_model(tcfg, fused_head=mode != "off")
        model.load_state_dict(state, strict=True)
        loss, aux = make_loss_fn(tcfg, "train")(model, tbatch, torch.Generator(), True)
        loss.backward()
        for k in keys:
            np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(aux["recon_ids"].numpy(), np.asarray(jaux["recon_ids"]))
        tgrads = {n: p.grad for n, p in model.named_parameters()}
        for name, g in _flat(jax.device_get(jgrads)):
            got = np.zeros_like(g) if tgrads[name] is None else tgrads[name].numpy()
            assert np.abs(got - g).max() <= 1e-4 * max(np.abs(g).max(), 1e-30), (mode, name)
        outs[mode] = (float(aux["loss_recon"].detach()), aux["recon_ids"].numpy())
    for mode in ("store", "flash"):
        np.testing.assert_allclose(outs[mode][0], outs["off"][0], rtol=1e-5)
        np.testing.assert_array_equal(outs[mode][1], outs["off"][1])


def test_fused_head_loss_refuses_a_logits_model():
    cfg = TorchRunConfig.from_flat_dict(_cfg("shelgon3", "store").get_config())
    ids = torch.ones((2, S), dtype=torch.long)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids), "n_valid": 2}
    with pytest.raises(ValueError, match="fused_head=True"):
        make_loss_fn(cfg, "val")(build_model(cfg), batch, torch.Generator(), True)


@pytest.mark.parametrize("fused_head_ce, over, want", [
    ("store", {}, "store"), ("flash", {}, "flash"), ("auto", {}, None), ("off", {}, None),
    ("store", {"decoder_model_name": "gpt2"}, None),
    ("flash", {"tie_word_embeddings": False}, None),
])
def test_resolve_head_ce_matches_jax(fused_head_ce, over, want):
    cfg = _cfg("bagon", fused_head_ce, **over)
    assert _resolve_head_ce(TorchRunConfig.from_flat_dict(cfg.get_config())) == want
    assert jax_resolve(cfg, None) == want
