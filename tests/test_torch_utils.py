"""The port's copies of the JAX package's framework-free utilities, held to the originals.

The constants are equal; the styled epoch line and the progress line
render the same text (colour forced on through a TTY-like stream and off
through a plain one); ``params_summary_dict`` gives the same counts per
component, with and without a ``vq-ft`` freezing mask, on a tiny Shelgon3-VQ.
"""

import io

import jax
import numpy as np
import pytest

from kindergarten_vq_vae_tpu.train.config import ModelConfig, RunConfig
from kindergarten_vq_vae_tpu.train.freezing import trainable_mask as jax_trainable_mask
from kindergarten_vq_vae_tpu.train.variants import init_params
from kindergarten_vq_vae_tpu.utils import console as jconsole
from kindergarten_vq_vae_tpu.utils import consts as jconsts
from kindergarten_vq_vae_tpu.utils.params import params_summary_dict as jax_summary
from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.config import RunConfig as TorchRunConfig
from kindergarten_vq_vae_torch.models import build_model
from kindergarten_vq_vae_torch.train.freezing import trainable_mask
from kindergarten_vq_vae_torch.utils import console, consts
from kindergarten_vq_vae_torch.utils.params import params_summary_dict

CONSTS = ("DS_GEN_SEED", "SUPPORTED_MODEL_MODES", "RUN_ID_TIMESTAMP_FORMAT",
          "CLEAN_FACTOR_COLUMNS", "FACTOR_MAX_SUPPORT", "EXPLICIT_FACTOR_VALUES")


def test_constants_equal_jax():
    for name in CONSTS:
        assert getattr(consts, name) == getattr(jconsts, name), name


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("tty", [True, False])
def test_console_renders_like_jax(monkeypatch, tty):
    monkeypatch.delenv("NO_COLOR", raising=False)
    stream = _Tty() if tty else io.StringIO()
    for mod in (console, jconsole):
        monkeypatch.setattr(mod.sys, "stdout", stream)
    parts, flags = ["loss_recon: 04.751023", "acc: 003.7109%", "12.5 sent/s"], [True, False, False]
    assert console.epoch_line(3, "val", parts, flags) == jconsole.epoch_line(3, "val", parts, flags)
    lines = []
    for mod in (console, jconsole):
        out = _Tty() if tty else io.StringIO()
        bar = mod.ProgressLine("epochs (shelgon3)", 4, stream=out)
        bar.t0 = 0.0
        monkeypatch.setattr(mod.time, "perf_counter", lambda: 90.0)
        bar.advance()
        bar.clear()
        lines.append(out.getvalue())
    assert lines[0] == lines[1] and bool(lines[0]) == tty


def test_params_summary_equals_jax():
    cfg = RunConfig(model=ModelConfig(
        model_name="shelgon3", vocab_size=40, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, compute_dtype="float32", vq_e_dim=32, enc_out_size=32, vq_n_e=5))
    params = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.key(0)))
    model = build_model(TorchRunConfig.from_flat_dict(cfg.get_config()))
    model.load_state_dict(params_from_jax(params), strict=True)
    parts = {k: params[k] for k in ("encoder", "decoder")}
    assert params_summary_dict(model) == jax_summary(parts)
    jmask = jax_trainable_mask(params, "vq-ft")
    mask = trainable_mask([n for n, _ in model.named_parameters()], "vq-ft")
    assert params_summary_dict(model, mask=mask) == jax_summary(
        parts, {k: jmask[k] for k in parts})
