"""The port's flat run configuration vs the JAX package's.

``RunConfig().get_config()`` has the same keys, in the same order, with the
same defaults as the JAX ``RunConfig().get_config()``; a ``run_conf.json``
written by either side (with values off their defaults, tuples included)
loads in the other to the same flat dict; ``--set`` overrides parse the same
way; what is not ported is refused with its ROADMAP item.
"""

import json

import pytest

from kindergarten_vq_vae_tpu.train.config import RunConfig as JaxRunConfig
from models._cli import _apply_overrides as jax_apply_overrides
from kindergarten_vq_vae_torch.cli import apply_overrides
from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported

CHANGED = {"model_name": "shelgon3", "model_mode": "vq-ft", "vq_n_e": 7, "lr": 3e-4,
           "milestones": [5, 9], "ckpt_slots": ["loss_recon:val"], "vq_ema_update": True,
           "decoder_perturb_train_pct": 0.15, "batch_size": 2048, "seed": 11,
           "bagon_target_unperturbed": True, "fused_update": "on", "ckpt_every_n_epochs": 0,
           "vq_codebook_init_values_path": "codes.npy"}


def test_schema_and_defaults_equal_jax():
    got, want = RunConfig().get_config(), JaxRunConfig().get_config()
    assert list(got) == list(want)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


@pytest.mark.parametrize("writer, reader", [(JaxRunConfig, RunConfig), (RunConfig, JaxRunConfig)])
def test_run_conf_json_loads_on_the_other_side(tmp_path, writer, reader):
    path = str(tmp_path / "run_conf.json")
    writer.from_flat_dict({**writer().get_config(), **CHANGED}).save(
        path, extra={"run_id": "r", "n_params": {"encoder": {"n_params": 1}}})
    got = reader.load(path).get_config()
    assert {k: got[k] for k in CHANGED} == CHANGED
    with open(path) as f:
        assert json.loads(json.dumps(got)) == {k: v for k, v in json.load(f).items()
                                               if k not in ("run_id", "n_params")}


def test_overrides_parse_like_the_jax_cli():
    sets = ["n_epochs=2", "lr=3e-4", "milestones=(3, 4)", "runs_dir=/tmp/x", "fused_ce=False",
            "vq_codebook_init_values_path=None"]
    got = apply_overrides(RunConfig(), sets).get_config()
    want = jax_apply_overrides(JaxRunConfig(), sets).get_config()
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    with pytest.raises(KeyError, match="unknown config key"):
        apply_overrides(RunConfig(), ["no_such_key=1"])


@pytest.mark.parametrize("override, item", [
    ({"model_name": "shelgon"}, None),
    # the id it had while the GPT-2 decoder was refused under that ROADMAP item
    pytest.param({"decoder_model_name": "gpt2"}, None, id="override1-other variants"),
    ({"vq_mode": "GumbelQuantizer"}, None),
    # the id it had while a mesh was refused under the ROADMAP item "multi-device"
    pytest.param({"mesh_shape": (1,), "mesh_axis_names": ("dp",)}, "world",
                 id="override3-multi-device"),
])
def test_refusals_name_their_roadmap_item(override, item):
    """Nothing is refused any more: the variants, the GPT-2 decoder and a
    mesh whose size is the world's (this process alone: 1) pass; a mesh of
    another size (``item`` "world"), or whose axis names do not pair up with
    its shape, raises ``ValueError`` naming both."""
    assert refuse_unported(RunConfig(**override)) is None
    if item is None:
        return
    with pytest.raises(ValueError, match=r"mesh_shape \(4,\) holds 4 ranks, the world has 1"):
        refuse_unported(RunConfig(**{**override, "mesh_shape": (4,)}))
    with pytest.raises(ValueError, match="must pair up"):
        refuse_unported(RunConfig(mesh_shape=(1, 1), mesh_axis_names=("dp",)))
