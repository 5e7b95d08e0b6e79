"""The port's config reader against PyYAML, on the CPU.

The port reads ``config/*.yaml`` and the CLI's overrides with its own
reader of a YAML subset (the card's machine has no PyYAML). Its value
must be PyYAML 1.1's (``yaml.safe_load``) or it must raise: on every
config file, on a list of override values chosen for YAML 1.1's traps
(``1e-3`` is a string, ``1.0e-3`` a float, ``yes`` a boolean, ``~``
null, ``0x10`` an int; octal, sexagesimal, ``.inf`` and escapes raise),
and on seeded random documents. The snapshot it
writes reads back through ``yaml.safe_load`` to the same dict. PyYAML
is used here only as the reference.
"""

import glob
import math
import os
import random

import numpy as np
import pytest
import torch
import yaml

from snn_for_object_detection_tpu.utils import config as jconfig
from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
from snn_for_object_detection_tpu_torch.models import TinyYolo, VggSNN, YoloSNN
from snn_for_object_detection_tpu_torch.utils import config
from snn_for_object_detection_tpu_torch.utils.config import (
    ConfigSyntaxError,
    dumps,
    loads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.yaml")))

# the reader gives PyYAML's value
TAKEN = [
    "1e-3", "1.0e-3", "1.0e+3", "1e+3", "1.", "-.5e-3", "+12",
    "yes", "no", "on", "Off", "TRUE", "y", "n", "~", "null", "Null", "",
    "0x10", "-0", "[1,2]", "[240, 304]", "[]", "{}",
    "{hflip: 0.5}", "{hflip: 0.5, polarity_swap: 0.25, pixel_dropout: 0.05}",
    "{a: , b: [1, {c: d}]}", "[a, [b, c], {}]", "'quoted'", '"quoted"',
    "'1e-3'", '"yes"',
    "foo bar", "./data_synth", "log/run", "http://host:80/x",
    "snn_for_object_detection_tpu.models.TinyYolo", "3 # a comment",
    "x#y", "-1", "--", "-x", "a: b", "- a\n- b", "k:\n- 1\n- 2",
]
# PyYAML gives a value the reader does not take: it raises (the other
# YAML 1.1 number forms, escapes, timestamps, anchors, block scalars,
# trailing commas, flow pairs, multi-line scalars)
REFUSED = [
    ".5", "010", "0b101", "0_", "1_000", "1:30", "1:30.5", ".inf", "-.inf",
    "+.inf", ".nan", "'it''s'", '"tab\\tand \\u00e9 \\x41 \\U0001F600"',
    '"\\\\"', "2001-12-14", "&a x", "|", "[1, 2, ]", "{a:1}", "[a: 1]",
    "a\nb", "?x",
]
# PyYAML raises
PYYAML_RAISES = [
    "*a", "!t x", "<<", "=", "a: b: c", '"unterminated', "'x' y",
    "\tx", "a: 1\n b: 2",
]
OVERRIDE_VALUES = TAKEN + REFUSED + PYYAML_RAISES


def _same(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def _check_against_pyyaml(text: str) -> bool:
    """True if the reader gave PyYAML's value, False if it raised; fails
    if it gave a value PyYAML does not give."""
    try:
        got = loads(text)
    except ConfigSyntaxError:
        return False
    want = yaml.safe_load(text)  # raises if PyYAML has no value
    assert _same(got, want), (text, got, want)
    return True


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_file_reads_as_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert _check_against_pyyaml(text)
    assert config.load_yaml(path) == jconfig.load_yaml(path)


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_override_values_read_as_pyyaml_or_raise(text):
    assert _check_against_pyyaml(text) == (text in TAKEN), text


def test_yaml_1_1_scalars():
    assert loads("1e-3") == "1e-3" and loads("1.0e-3") == 1.0e-3
    assert loads("yes") is True and loads("off") is False
    assert loads("~") is None and loads("0x10") == 16
    assert loads("1.0e3") == "1.0e3" and loads("-1.5e+2") == -150.0
    for text in ("010", "1:30", ".inf", "1_000", '"a\\tb"'):
        with pytest.raises(ConfigSyntaxError):
            loads(text)


TOKENS = [
    " - ", " '", "' ", ' "', " [", "a", "b1", "1", "1.0", "e-3", "e+3",
    ":", ": ", " ", "- ", "-", "[", "]", "{", "}", ", ", ",", "'", '"',
    " #c", "#", "\n", "\n  ", "\n    ", "yes", "~", "0x1f", "_", ".",
    "null", "on", "0", "07", "09", "k: ", "k2: ", "\n- ", "\n  - ", "x/y",
    "?", "!", "&", "*", "|", "%", "@", "''", "\\", "\\n", "-1", "+",
    ".inf", "\r\n",
]


def test_random_documents_read_as_pyyaml_or_raise():
    rng = random.Random(0)
    taken = 0
    for _ in range(4000):
        text = "".join(rng.choice(TOKENS)
                       for _ in range(rng.randint(1, 10)))
        taken += _check_against_pyyaml(text)
    assert taken > 1000  # the reader takes a good share of them


def test_overrides_and_merge_match_the_jax_package():
    files = [os.path.join(REPO, "config", f)
             for f in ("config.yaml", "synthetic.yaml", "fast.yaml")]
    overrides = ["--data.init_args.data_dir=/tmp/x",
                 "--model.init_args.learning_rate=1e-3",
                 "--model.init_args.time_window=0",
                 "--data.init_args.augment={hflip: 0.5}",
                 "--trainer.time_batched=true", "--ckpt_path=auto",
                 "--trainer.limit_train_batches=0x10"]
    assert config.parse_overrides(overrides) == \
        jconfig.parse_overrides(overrides)
    got = config.load_config(files, overrides)
    assert got == jconfig.load_config(files, overrides)
    assert got["model"]["init_args"]["learning_rate"] == "1e-3"
    with pytest.raises(ValueError, match="dotted.key=value"):
        config.parse_overrides(["--no_value"])


def test_snapshot_reads_back_through_pyyaml(tmp_path):
    cfg = config.load_config(CONFIGS[:1], ["--trainer.out_dir=log/run"])
    cfg["tricky"] = {
        "strings": ["yes", "1e-3", "", " padded ", "a: b", "# not", "-",
                    "é ü", "\U0001F600", "it's", 'say "hi"', "C:\\dir",
                    "...", "null", "0x10", "010", "1:30", "[1]", "{}", "~"],
        "numbers": [0, -7, 2 ** 70, 1e-5, -1.5e-07, 1e16, 123.0, 0.1],
        "flags": [True, False, None],
        "nested": [{"class_path": "a.B", "init_args": {"k": [1, 2]}}],
        "empty": {}, "list": [], 3: "int key", "on": "string key",
    }
    path = config.save_config_snapshot(cfg, str(tmp_path / "run"))
    with open(path) as f:
        text = f.read()
    assert yaml.safe_load(text) == cfg
    assert loads(text) == cfg
    assert config.load_yaml(path) == cfg
    # what would need an escape, and types the configs do not hold
    for value in ("tab\tnew\nline", "'\"\\", "'\\", math.inf, math.nan,
                  np.float32(1.0)):
        with pytest.raises(ValueError, match="cannot write"):
            dumps({"x": value})


def test_random_snapshots_read_back_through_pyyaml():
    rng = random.Random(1)
    alphabet = "ab_/.:-# '\"\\\n\té1eE+0x~"

    def value(depth, kinds=7):
        kind = rng.randrange(kinds if depth < 3 else 5)
        if kind == 0:
            return "".join(rng.choice(alphabet)
                           for _ in range(rng.randint(0, 6)))
        if kind == 1:
            return rng.choice([0, 1, -3, 10 ** 20, True, False, None])
        if kind == 2:
            return rng.choice([0.0, -0.5, 1e-9, 3.25e12, 1 / 3, 1e300])
        if kind in (3, 4):
            return rng.choice(["yes", "No", "~", "1e3", "010", "", "-"])
        if kind == 5:
            return [value(depth + 1) for _ in range(rng.randint(0, 3))]
        return {value(0, kinds=5) if rng.random() < 0.2 else f"k{i}":
                value(depth + 1) for i in range(rng.randint(0, 3))}

    def strings(node):
        if isinstance(node, dict):
            return [s for k, v in node.items()
                    for s in strings(k) + strings(v)]
        if isinstance(node, list):
            return [s for v in node for s in strings(v)]
        return [node] if isinstance(node, str) else []

    written = 0
    for _ in range(300):
        cfg = {f"top{i}": value(0) for i in range(3)}
        try:
            text = dumps(cfg)
        except ValueError:
            # only a string that needs an escape is refused
            assert any(not s.isprintable() or ("'" in s and (
                '"' in s or "\\" in s)) for s in strings(cfg)), cfg
            continue
        written += 1
        assert yaml.safe_load(text) == cfg, text
        assert loads(text) == cfg, text
    assert written > 100


def test_class_paths_of_the_jax_package_name_the_port():
    assert config.port_class_path(
        "snn_for_object_detection_tpu.models.TinyYolo") == \
        "snn_for_object_detection_tpu_torch.models.TinyYolo"
    assert config.port_class_path("collections.OrderedDict") == \
        "collections.OrderedDict"
    data = config.instantiate({
        "class_path": "snn_for_object_detection_tpu.data."
                      "PropheseeDataModule",
        "init_args": {"data_dir": "/nowhere", "batch_size": 3}})
    assert type(data) is PropheseeDataModule and data.batch_size == 3
    made = config.instantiate(
        {"a": [{"class_path": "collections.OrderedDict"}], "b": 1})
    assert made == {"a": [{}], "b": 1}


@pytest.mark.parametrize("path", [
    "utils.Plotter", "train.TensorBoardLogger", "train.CSVLogger",
])
def test_plotter_and_loggers_instantiate_the_port_s(path):
    """The class paths of ``config/config.yaml``'s plotter and
    ``config/logger.yaml``'s back ends name the port's classes."""
    made = config.instantiate(
        {"class_path": f"snn_for_object_detection_tpu.{path}"})
    module, _, name = path.rpartition(".")
    assert type(made).__name__ == name
    assert type(made).__module__.startswith(
        f"snn_for_object_detection_tpu_torch.{module}")


@pytest.mark.parametrize("path,init_args,cls", [
    ("models.VggSNN", {"num_classes": 2, "in_hw": [32, 40],
                       "neuron": "plif", "widths": [8, 12, 16]}, VggSNN),
    ("models.YoloSNN", {"num_classes": 2, "in_hw": [32, 40],
                        "scale": "tiny"}, YoloSNN),
])
def test_zoo_classes_instantiate(path, init_args, cls):
    """The JAX package's model zoo class paths name the port's classes
    (the model zoo is ported)."""
    model = config.instantiate(
        {"class_path": f"snn_for_object_detection_tpu.{path}",
         "init_args": init_args}, device="cpu")
    assert type(model) is cls


@pytest.mark.parametrize("overlay,dtypes", [
    ("infer_fp8.yaml", (torch.bfloat16, torch.float8_e5m2)),
    ("fast.yaml", (torch.float32, torch.bfloat16)),
])
def test_model_dtype_strings_become_torch_dtypes(overlay, dtypes):
    cfg = config.load_config([os.path.join(REPO, "config", "config.yaml"),
                              os.path.join(REPO, "config", overlay)])
    model = config.instantiate(cfg["model"], device="cpu")
    assert type(model) is TinyYolo
    assert (model.compute_dtype, model.state_dtype) == dtypes
    # e4m3 states (stored as JAX stores them, neurons.to_state)
    cfg["model"]["init_args"]["state_dtype"] = "float8_e4m3fn"
    model = config.instantiate(cfg["model"], device="cpu")
    assert model.state_dtype == torch.float8_e4m3fn
