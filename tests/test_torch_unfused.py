"""The port's per-module BERT trunk (``fused_layer`` off) vs the JAX package's
flax ``BertModel`` / ``BertLMHeadModel`` with ``fused_layer=False``.

A tiny geometry (2 layers, H 64, 4 heads, F 128, vocab 97, S 12), f32,
``deterministic=True``, flax's initial weights plus seeded noise on every
leaf, carried across by ``ckpt/bridge.py``; padded self-attention masks and,
in the decoder, a padded cross-attention mask. Both attention cores:
``fused_sdpa`` on (JAX: the Pallas SDPA kernels in interpret mode; the port:
kernels #11 / #12's plain versions) and off (the einsum route on both
sides). Held: the outputs (``last_hidden_state`` and ``pooler_output``, or
the logits) at atol 1e-5, and the gradients of a weighted sum of them, for
every parameter leaf and the encoder states fed to the decoder, at
max|port - jax| / max|jax| <= 1e-5 per leaf (f32 on both sides; summation
order and exp / erf ulps only). With ``output_attentions`` every layer's
self- and cross-attention probabilities are held in shape and at atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.nn.bert import BertConfig as JaxBertConfig
from kindergarten_vq_vae_tpu.nn.bert import BertLMHeadModel as JaxLMHead
from kindergarten_vq_vae_tpu.nn.bert import BertModel as JaxBert
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertLMHeadModel, BertModel

B, S, SK, V = 5, 12, 12, 97
GEOM = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(1, V, (B, S)) * mask).astype(np.int32)
    enc = rng.normal(size=(B, SK, 64)).astype(np.float32)
    cmask = (np.arange(SK)[None] < rng.integers(4, SK + 1, B)[:, None]).astype(np.int32)
    return ids, mask, enc, cmask, rng


def _models(decoder: bool, sdpa: bool, rng):
    extra = dict(is_decoder=True, add_cross_attention=True) if decoder else {}
    jcfg = JaxBertConfig(**GEOM, **extra, fused_layer=False, fused_sdpa=sdpa, sdpa_block_b=2)
    jmodel = JaxLMHead(jcfg) if decoder else JaxBert(jcfg)
    ids = jnp.ones((B, S), jnp.int32)
    kw = dict(encoder_hidden_states=jnp.zeros((B, SK, 64))) if decoder else {}
    params = jmodel.init(jax.random.key(0), ids, ids, **kw)["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(scale=0.05, size=p.shape).astype(np.float32), params)
    tcfg = BertConfig(**GEOM, **extra, fused_layer=False, fused_sdpa=sdpa)
    tmodel = BertLMHeadModel(tcfg) if decoder else BertModel(tcfg)
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jmodel, params, tmodel


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("decoder", [False, True])
@pytest.mark.parametrize("sdpa", [True, False])
def test_per_module_trunk_matches_flax(decoder, sdpa):
    ids, mask, enc, cmask, rng = _data()
    jmodel, params, tmodel = _models(decoder, sdpa, rng)
    keys = ("logits",) if decoder else ("last_hidden_state", "pooler_output")
    ws = {k: rng.normal(size=(B, S, V) if k == "logits" else (B, S, 64) if k[0] == "l"
                        else (B, 64)).astype(np.float32) for k in keys}

    def jloss(p, e):
        kw = {}
        if decoder:
            kw = dict(encoder_hidden_states=e, encoder_attention_mask=jnp.asarray(cmask))
        out = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask), **kw)
        return sum(jnp.sum(out[k] * ws[k]) for k in keys), out

    (_, jout), (jgrads, jdenc) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        params, jnp.asarray(enc))
    tenc = torch.from_numpy(enc).requires_grad_()
    kw = dict(encoder_hidden_states=tenc, encoder_attention_mask=torch.from_numpy(cmask)) \
        if decoder else {}
    tout = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask), **kw)
    sum((tout[k] * torch.from_numpy(ws[k])).sum() for k in keys).backward()

    for k in keys:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=1e-5,
                                   err_msg=k)
    tgrads = {n: p.grad for n, p in tmodel.named_parameters()}
    for name, g in _flat(jax.device_get(jgrads)):
        got = np.zeros_like(g) if tgrads[name] is None else tgrads[name].numpy()
        assert _rel(got, g) <= 1e-5, name
    if decoder:
        assert _rel(tenc.grad.numpy(), np.asarray(jdenc)) <= 1e-5


@pytest.mark.parametrize("decoder", [False, True])
def test_output_attentions_match_flax(decoder):
    """``output_attentions`` takes the einsum route (even with fused_sdpa on)
    and returns each layer's probabilities before dropout."""
    ids, mask, enc, cmask, rng = _data(1)
    jmodel, params, tmodel = _models(decoder, True, rng)
    jkw = dict(encoder_hidden_states=jnp.asarray(enc),
               encoder_attention_mask=jnp.asarray(cmask)) if decoder else {}
    jout = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                        output_attentions=True, **jkw)
    tkw = dict(encoder_hidden_states=torch.from_numpy(enc),
               encoder_attention_mask=torch.from_numpy(cmask)) if decoder else {}
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                      output_attentions=True, **tkw)
    for key in ("attentions", "cross_attentions"):
        assert len(tout[key]) == len(jout[key]) == GEOM["num_layers"]
        for got, want in zip(tout[key], jout[key]):
            if want is None:
                assert got is None and not decoder
                continue
            assert got.shape == (B, 4, S, SK if key[0] == "c" else S)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
            np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    out_key = "logits" if decoder else "last_hidden_state"
    np.testing.assert_allclose(tout[out_key].numpy(), np.asarray(jout[out_key]), atol=1e-5)
