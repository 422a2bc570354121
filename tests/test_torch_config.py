"""The port's config (deepdfa_tpu_torch/core/config.py) reads the same
JSON files as the reference and keeps the reference's field names and
defaults for every field it holds; the kernel variants this slice has
not ported raise NotImplementedError."""

import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.core import config as jcfg  # noqa: E402
from deepdfa_tpu_torch.core import config as tcfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["FeatureSpec", "ModelConfig", "BatchConfig", "ServeConfig"])
def test_fields_and_defaults_match_reference(name):
    port = getattr(tcfg, name)()
    ref = getattr(jcfg, name)()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    if name != "ServeConfig":  # the port's serve section is the batcher's part
        assert {f.name for f in dataclasses.fields(port)} == {
            f.name for f in dataclasses.fields(ref)
        }


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")))
def test_loads_the_shared_json_files(path):
    port = tcfg.load(path)
    ref = jcfg.load(path)
    for section in ("model", "serve"):
        for f in dataclasses.fields(getattr(port, section)):
            assert getattr(getattr(port, section), f.name) == getattr(
                getattr(ref, section), f.name
            ), f"{section}.{f.name}"
    assert port.data.batch == tcfg.BatchConfig(**dataclasses.asdict(ref.data.batch))
    assert port.data.feat.input_dim == ref.data.feat.input_dim
    assert port.data.feat.subkeys == ref.data.feat.subkeys


def test_flagship_serving_budgets():
    cfg = tcfg.load(ROOT / "configs" / "bigvul_deepdfa.json")
    assert cfg.data.feat.input_dim == 1002
    assert (cfg.model.hidden_dim, cfg.model.n_steps, cfg.model.num_output_layers) == (32, 5, 3)
    assert tcfg.serve_budgets(cfg) == (16384, 65536)
    assert cfg.serve.max_batch_graphs == 16
    small = dataclasses.replace(cfg, serve=tcfg.ServeConfig(node_budget=512, edge_budget=2048))
    assert tcfg.serve_budgets(small) == (512, 2048)


@pytest.mark.parametrize(
    "knob, value, error",
    [
        ("ggnn_kernel_accum", "bf16", NotImplementedError),
        ("ggnn_kernel_accum", "int8", NotImplementedError),
        ("ggnn_kernel_unroll", "fused", NotImplementedError),
        ("ggnn_kernel_scatter", "mxu", NotImplementedError),
        ("ggnn_kernel_accum", "fp64", ValueError),
        ("ggnn_kernel_unroll", "whole", ValueError),
    ],
)
def test_unported_kernel_variants_raise(knob, value, error):
    with pytest.raises(error):
        tcfg.ModelConfig(**{knob: value})
    with pytest.raises(error):
        tcfg.from_dict({"model": {knob: value}})
