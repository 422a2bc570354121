"""The port's config (deepdfa_tpu_torch/core/config.py) reads the same
JSON files as the reference and keeps the reference's field names and
defaults for every field it holds; every GGNN kernel variant of the
reference loads, and unknown ones raise as in the reference."""

import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.core import config as jcfg  # noqa: E402
from deepdfa_tpu_torch.core import config as tcfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["FeatureSpec", "ModelConfig", "BatchConfig", "ServeConfig",
                                  "ScanConfig"])
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
    for section in ("model", "serve", "scan"):
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
        ("ggnn_kernel_scatter", "onehot", ValueError),
        ("ggnn_kernel_accum", "fp64", ValueError),
        ("ggnn_kernel_unroll", "whole", ValueError),
    ],
)
def test_unported_kernel_variants_raise(knob, value, error):
    """An unknown scatter, policy or unroll raises when the config loads
    (the reference raises when it builds the step)."""
    with pytest.raises(error):
        tcfg.ModelConfig(**{knob: value})
    with pytest.raises(error):
        tcfg.from_dict({"model": {knob: value}})


@pytest.mark.parametrize(
    "overrides",
    [["model.ggnn_kernel_accum=\"bf16\""], ["model.ggnn_kernel_accum=\"int8\""],
     ["model.ggnn_kernel_unroll=\"fused\""],
     ["model.ggnn_kernel_accum=\"int8\"", "model.ggnn_kernel_unroll=\"fused\""],
     ["model.ggnn_kernel_scatter=\"mxu\""],
     ["model.ggnn_kernel_scatter=\"mxu\"", "model.ggnn_kernel_accum=\"int8\"",
      "model.ggnn_kernel_block_edges=128"],
     ["model.ggnn_kernel_scatter=\"mxu\"", "model.ggnn_kernel_accum=\"bf16\"",
      "model.ggnn_kernel_unroll=\"fused\""]],
    ids=["bf16", "int8", "fused", "int8_fused", "mxu", "mxu_int8_be128", "mxu_bf16_fused"],
)
def test_ported_kernel_variants_load_like_the_reference(overrides):
    """The reference's flagship config with the kernel and its policy
    and unroll knobs loads in the port with the same model fields."""
    overrides = ["model.ggnn_kernel=true", *overrides]
    port = tcfg.apply_overrides(tcfg.load(ROOT / "configs" / "bigvul_deepdfa.json"), overrides)
    ref = jcfg.apply_overrides(jcfg.load(ROOT / "configs" / "bigvul_deepdfa.json"), overrides)
    for f in dataclasses.fields(tcfg.ModelConfig):
        assert getattr(port.model, f.name) == getattr(ref.model, f.name), f.name


OVERRIDES = [
    "train.optim.learning_rate=true",
    "train.optim.learning_rate=1",
    "train.optim.learning_rate=0.5",
    "model.hidden_dim=1.5",
    "model.hidden_dim=true",
    "model.hidden_dim=64",
    "model.concat_all_absdf=1",
    "model.concat_all_absdf=false",
    "train.pos_weight=abc",
    "train.pos_weight=2.5",
    "train.pos_weight=null",
    "data.seq_buckets=[16, 32]",
    "data.seq_buckets=5",
    "run_name=x",
    "run_name=3",
    "train.optim=3",
    'train.optim={"learning_rate": 0.25}',
    "model.nope=1",
    "nope.key=1",
    "noequals",
]


@pytest.mark.parametrize("override", OVERRIDES)
def test_overrides_accept_and_refuse_what_the_reference_does(override):
    """The same override list through both packages: the same exception
    type where the reference refuses (a bool for a float, a float for an
    int, non-JSON for a None field, a scalar for a section, unknown
    keys), the same value where it accepts (an int widens to a float)."""
    try:
        ref = jcfg.apply_overrides(jcfg.Config(), [override])
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            tcfg.apply_overrides(tcfg.Config(), [override])
        return
    port = tcfg.apply_overrides(tcfg.Config(), [override])
    key = override.partition("=")[0]
    got, want = port, ref
    for part in key.split("."):
        got, want = getattr(got, part), getattr(want, part)
    if dataclasses.is_dataclass(got):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        want = {k: want[k] for k in got}
    assert got == want and type(got) is type(want), (got, want)


@pytest.mark.parametrize("gtype, n_etypes, ok", [("cfg", 1, True), ("cfg+dep", 3, True),
                                                 ("cfg+dep", 2, False), ("pdg", 3, False),
                                                 ("ast", 1, False)])
def test_validate_checks_etypes_against_gtype_like_the_reference(gtype, n_etypes, ok):
    overrides = [f'data.gtype="{gtype}"', f"model.n_etypes={n_etypes}"]
    for mod in (jcfg, tcfg):
        cfg = mod.apply_overrides(mod.Config(), overrides)
        if ok:
            mod.validate(cfg)
        else:
            with pytest.raises(ValueError, match="gtype|n_etypes"):
                mod.validate(cfg)
    assert tcfg.GTYPE_ETYPES == jcfg.GTYPE_ETYPES
    from deepdfa_tpu_torch import cli

    args = cli.build_parser().parse_args(["train", "--device", "cpu", *overrides])
    if ok:
        assert cli._load_config(args).model.n_etypes == n_etypes
    else:  # the command refuses the config before it reads any data
        with pytest.raises(ValueError):
            cli._load_config(args)


@pytest.mark.parametrize("name", ["debug_nans", "enable_checks"])
def test_sanitizer_switches_are_read_and_refused(name):
    """train.debug_nans / train.enable_checks are fields of the port's
    config with the reference's defaults, read from JSON (not passed
    over), and taken by every trainer of the port (the reference's
    `_load_config` applies them to every command): the refusal rule of
    the trainers without the runtime hooks refuses the resilient runtime
    beside them, never the sanitizer."""
    assert getattr(tcfg.TrainConfig(), name) is getattr(jcfg.TrainConfig(), name) is False
    cfg = tcfg.from_dict({"train": {name: True}})
    assert getattr(cfg.train, name) is True
    tcfg.refuse_unported_training(tcfg.Config())
    tcfg.refuse_unported_training(cfg)
    tcfg.refuse_unported_training(cfg, runtime_hooks=True)
    over = tcfg.apply_overrides(tcfg.Config(), [f"train.{name}=true"])
    tcfg.refuse_unported_training(over)
    with pytest.raises(NotImplementedError, match="resilience"):
        tcfg.refuse_unported_training(tcfg.apply_overrides(
            over, ["train.resilience.enabled=true"]))
