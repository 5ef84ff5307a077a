"""The port's ``nn/convert_hf.py`` vs the JAX package's, on HF BERT models.

HF models are built from a config with random weights (no download), as
``tests/test_bert_parity.py`` builds them, at a tiny size (vocab 97, H 32, 2
layers, 2 heads, F 64, 48 positions), on the CPU in f32:

- the encoder, the decoder with cross-attention and its fresh
  cross-attention (an MLM checkpoint without it): the port's converted state
  dict equals ``params_from_jax`` of JAX's converted tree leaf for leaf, bit
  for bit, and loads strictly into the port's module, whose forward matches
  the HF model's at ``test_bert_parity.py``'s bars (rtol 2e-4 / 3e-4, atol
  2e-5 / 3e-5);
- ``init_encoder_decoder``: converted leaves from the checkpoint, the
  cross-attention the fresh initial values of the same generator;
- the export round trip: the port's ``export_*`` equal JAX's on the same
  weights, key for key, and give back the HF state dict it was converted
  from.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from kindergarten_vq_vae_tpu.nn import convert_hf as jax_convert
from kindergarten_vq_vae_tpu.nn.bert import BertConfig as JaxBertConfig
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax, params_to_jax
from kindergarten_vq_vae_torch.nn import convert_hf
from kindergarten_vq_vae_torch.nn.bert import BertConfig, BertLMHeadModel, BertModel

os.environ.setdefault("USE_TF", "0")  # the HF models here are torch's: skip TensorFlow
transformers = pytest.importorskip("transformers")

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=48, hidden_dropout=0.0, attention_dropout=0.0)
DECODER = dict(is_decoder=True, add_cross_attention=True, add_pooler=False)


def _hf(decoder: bool, seed: int):
    cfg = transformers.BertConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  max_position_embeddings=48, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0, is_decoder=decoder,
                                  add_cross_attention=decoder)
    torch.manual_seed(seed)
    cls = transformers.BertLMHeadModel if decoder else transformers.BertModel
    return cls(cfg).eval()


def _cfgs(decoder: bool):
    extra = DECODER if decoder else {}
    return BertConfig(**TINY, **extra), JaxBertConfig(**TINY, **extra)


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 97, (3, 10))
    mask = np.ones((3, 10), np.int64)
    mask[0, -3:] = 0
    return torch.from_numpy(ids), torch.from_numpy(mask)


def test_encoder_converts_as_jax_and_matches_hf():
    cfg, jcfg = _cfgs(False)
    hf = _hf(False, 0)
    sd = hf.state_dict()
    got = convert_hf.convert_encoder_state_dict(sd, cfg)
    _same(got, params_from_jax(jax_convert.convert_encoder_state_dict(sd, jcfg)))
    model = BertModel(cfg)
    model.load_state_dict(got, strict=True)
    ids, mask = _batch(0)
    with torch.no_grad():
        ref = hf(ids, attention_mask=mask)
        out = model(ids, mask)
    np.testing.assert_allclose(out["last_hidden_state"].numpy(), ref.last_hidden_state.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out["pooler_output"].numpy(), ref.pooler_output.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_decoder_converts_as_jax_and_matches_hf():
    cfg, jcfg = _cfgs(True)
    hf = _hf(True, 1)
    sd = hf.state_dict()
    got = convert_hf.convert_decoder_state_dict(sd, cfg)
    _same(got, params_from_jax(jax_convert.convert_decoder_state_dict(sd, jcfg)))
    model = BertLMHeadModel(cfg)
    model.load_state_dict(got, strict=True)
    ids, mask = _batch(1)
    enc = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 10, 32)).astype(np.float32))
    with torch.no_grad():
        ref = hf(ids, attention_mask=mask, encoder_hidden_states=enc, output_attentions=True)
        out = model(ids, mask, encoder_hidden_states=enc, output_attentions=True)
    np.testing.assert_allclose(out["logits"].numpy(), ref.logits.numpy(), rtol=3e-4, atol=3e-5)
    for got_a, want_a in zip(out["cross_attentions"], ref.cross_attentions):
        np.testing.assert_allclose(got_a.numpy(), want_a.numpy(), rtol=3e-4, atol=3e-5)


def test_fresh_cross_attention_as_from_encoder_decoder_pretrained():
    """An MLM checkpoint without cross-attention: every leaf it has is
    converted, the cross-attention keeps the fresh values, as JAX's converter
    keeps them given the same fresh tree."""
    cfg, jcfg = _cfgs(True)
    enc_cfg = BertConfig(**TINY)
    hf = _hf(True, 3)
    sd = {k: v for k, v in hf.state_dict().items() if "crossattention" not in k}
    enc_sd = _hf(False, 4).state_dict()
    encoder, decoder = convert_hf.init_encoder_decoder(
        torch.Generator().manual_seed(7), enc_cfg, cfg, encoder_state_dict=enc_sd,
        decoder_state_dict=sd)
    _, fresh = convert_hf.init_encoder_decoder(torch.Generator().manual_seed(7), enc_cfg, cfg)
    fresh = fresh.state_dict()
    got = decoder.state_dict()
    _same(got, params_from_jax(
        jax_convert.convert_decoder_state_dict(sd, jcfg, params_to_jax(fresh))))
    cross = [k for k in got if ".cross_attn." in k]
    assert len(cross) == 2 * 8
    for k in cross:
        assert torch.equal(got[k], fresh[k]), k
    hf_out = sd["bert.encoder.layer.0.attention.output.dense.weight"].numpy().T
    np.testing.assert_array_equal(got["bert.layer_0.self_attn.out.kernel"].numpy(), hf_out)
    hf_q = hf.state_dict()["bert.encoder.layer.0.crossattention.self.query.weight"].numpy().T
    assert not np.allclose(got["bert.layer_0.cross_attn.q.kernel"].numpy(), hf_q)
    _same(encoder.state_dict(), convert_hf.convert_encoder_state_dict(enc_sd, enc_cfg))


@pytest.mark.parametrize("decoder", [False, True], ids=["encoder", "decoder"])
def test_export_round_trip_matches_jax(decoder):
    cfg, jcfg = _cfgs(decoder)
    sd = _hf(decoder, 5).state_dict()
    kind = "decoder" if decoder else "encoder"
    params = getattr(convert_hf, f"convert_{kind}_state_dict")(sd, cfg)
    got = getattr(convert_hf, f"export_{kind}_state_dict")(params, cfg)
    tree = jax.tree_util.tree_map(np.asarray, params_to_jax(params))
    want = getattr(jax_convert, f"export_{kind}_state_dict")(tree, jcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k, v in sd.items():
        if k in got:
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    missing = {k for k in sd if k not in got}
    assert not {k for k in missing if "position_ids" not in k and "token_type_ids" not in k}
    module = (BertLMHeadModel if decoder else BertModel)(dataclasses.replace(cfg))
    module.load_state_dict(params, strict=True)
    module_export = getattr(convert_hf, f"export_{kind}_state_dict")(module, cfg)
    assert all(np.array_equal(module_export[k], got[k]) for k in got)
