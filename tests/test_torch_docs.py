"""The port's API reference: the committed ``docs/api_torch`` pages must
match what ``scripts/gen_api_docs_torch.py`` generates from the current
docstrings (``tests/test_docs.py``'s check, for the port); they cover
every public module of the port and its core symbols; and generating
them imports the CUDA and native modules without building a kernel or
importing JAX."""

import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "gen_api_docs_torch.py")


def _load_generator():
    spec = importlib.util.spec_from_file_location("gen_api_docs_torch",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_api_docs_are_current():
    pages = _load_generator().generate()
    assert len(pages) > 30
    stale = []
    for rel, content in pages.items():
        path = os.path.join(REPO, rel)
        if not os.path.exists(path):
            stale.append(f"missing: {rel}")
            continue
        with open(path) as f:
            if f.read() != content:
                stale.append(f"outdated: {rel}")
    committed = set(os.listdir(os.path.join(REPO, "docs", "api_torch")))
    extra = committed - {os.path.basename(rel) for rel in pages}
    stale += [f"no longer generated: {name}" for name in sorted(extra)]
    assert not stale, (
        "the port's API docs drifted from its docstrings — run "
        "`python scripts/gen_api_docs_torch.py`:\n" + "\n".join(stale))


def test_api_docs_cover_every_module_and_core_symbols():
    gen = _load_generator()
    pages = gen.generate()
    names = {os.path.basename(rel) for rel in pages}
    for module in ("cli", "export", "import_torch_ckpt", "models.convert",
                   "ops.cuda_kernels", "ops.cuda_build", "parallel.halo",
                   "train.optax_rules", "models.detector", "train.loop",
                   "serve", "native.bindings"):
        assert module.replace(".", "_") + ".md" in names, module
    text = "\n".join(pages.values())
    for symbol in ("class SODa", "class TinyYolo", "class Trainer",
                   "class StreamingMegakernel", "class StreamingEngine",
                   "temporal_cell_seq", "spiking_conv_seq", "export_predict",
                   "load_predict", "make_mesh"):
        assert symbol in text, f"{symbol} missing from the port's API docs"
    index = pages[os.path.join("docs", "api_torch", "index.md")]
    for rel in pages:
        if not rel.endswith("index.md"):
            assert f"]({os.path.basename(rel)})" in index, rel


# run in a fresh process: every compiler call goes through subprocess, and
# every library the repository builds is loaded through ctypes.CDLL
GENERATE = r"""
import ctypes, os, subprocess, sys
repo = os.getcwd()
calls = []
popen = subprocess.Popen.__init__
def record(self, args, *a, **kw):
    calls.append(args)
    return popen(self, args, *a, **kw)
subprocess.Popen.__init__ = record
cdll = ctypes.CDLL.__init__
def load(self, name, *a, **kw):
    if str(name).startswith(repo):
        calls.append(name)
    return cdll(self, name, *a, **kw)
ctypes.CDLL.__init__ = load
sys.argv = [sys.argv[1]]
import runpy
runpy.run_path(sys.argv[0], run_name="gen")["generate"]()
print(calls)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib",
                                    "snn_for_object_detection_tpu")))
"""


def test_generating_the_pages_builds_no_kernel():
    out = subprocess.run([sys.executable, "-c", GENERATE, SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    calls, banned = out.stdout.strip().splitlines()[-2:]
    assert calls == "[]", f"a build or a library load: {calls}"
    assert banned == "[]", banned

