"""The port's data pipeline against the JAX package's, on the CPU.

- ``make_synthetic_dataset`` writes byte-identical files in both
  packages for one seed;
- ``PropheseeDataModule`` with one worker thread gives bit-equal frames
  and labels to JAX's for GEN1 single-target, GEN1 multi-target, 1Mpx
  single-target with its x clip (a recording with events past the right
  edge), and with train-split augmentation;
- the port's native decode and rasterizer (``native/event_ops.cc``,
  built with g++) are bit-equal to their numpy versions for float32 and
  uint8 frames, with and without the x clip, on empty slices and on
  events outside the window and the frame; a failed build raises;
- four Adamax steps of JAX's jitted train step on JAX-loader batches and
  of the port's ``Trainer.train_step`` on port-loader batches, narrow
  TinyYolo at GEN1 geometry from the same weights: losses within rtol
  1e-3 (the bar of ``test_adamax_trajectory_matches_jax_trainer``).
"""

import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.data import (
    PropheseeDataModule as JDataModule,
)
from snn_for_object_detection_tpu.data.psee import EventReader as JReader
from snn_for_object_detection_tpu.data.synthetic import (
    make_synthetic_dataset as j_make_synthetic_dataset,
)
from snn_for_object_detection_tpu.parallel import shard_batch
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu_torch.data import (
    EventReader,
    PropheseeDataModule,
    write_dat,
)
from snn_for_object_detection_tpu_torch.data.synthetic import (
    generate_recording,
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.native import bindings
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import JNarrow, PNarrow, _jax_weights

torch.set_num_threads(1)

GEN1_HW = (240, 304)
BATCHES = 3


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def gen1(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen1"))
    return make_synthetic_dataset(root, records_per_split=1,
                                  duration_ms=1200)


@pytest.fixture(scope="module")
def mpx(tmp_path_factory):
    """Small 1Mpx recordings (720x1280), and in the train split one more
    whose events run up to 600 px past the right edge, so the x clip of
    the 1Mpx stream has work to do."""
    root = str(tmp_path_factory.mktemp("mpx"))
    make_synthetic_dataset(root, dataset="1mpx", records_per_split=1,
                           duration_ms=600, height=720, width=1280)
    t, x, y, p, gt = generate_recording(duration_ms=600, height=720,
                                        width=1280, seed=5, time_field="t")
    x = x.astype(np.int64)
    shift = np.random.default_rng(5).random(x.size) < 0.2
    x[shift] += 600
    assert (x >= 1280).any()
    d = os.path.join(root, "1mpx", "train")
    write_dat(os.path.join(d, "rec9_td.dat"), t, x, y, p, 1280, 720)
    np.save(os.path.join(d, "rec9_bbox.npy"), gt)
    return root


@pytest.mark.parametrize("dataset", ["gen1", "1mpx"])
def test_synthetic_files_byte_identical_to_jax(tmp_path, dataset):
    kw = dict(dataset=dataset, records_per_split=1, duration_ms=400,
              seed=3)
    if dataset == "1mpx":
        kw.update(height=720, width=1280)
    ours = make_synthetic_dataset(str(tmp_path / "port"), **kw)
    theirs = j_make_synthetic_dataset(str(tmp_path / "jax"), **kw)
    files = _tree_files(ours)
    assert files == _tree_files(theirs) and len(files) == 6
    for f in files:
        with open(os.path.join(ours, f), "rb") as a, \
                open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f


SETUPS = {
    "gen1_st": dict(split="train"),
    "gen1_mt": dict(split="val", one_label=False),
    "1mpx_st_clip": dict(split="train", dataset="1mpx", num_load_file=2,
                         batch_size=1),
    "augment": dict(split="train", augment={
        "hflip": 0.5, "polarity_swap": 0.25, "pixel_dropout": 0.05}),
}


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_loader_bit_equal_to_jax(gen1, mpx, setup):
    kw = dict(SETUPS[setup])
    split = kw.pop("split")
    kw = {"data_dir": mpx if kw.get("dataset") == "1mpx" else gen1,
          "batch_size": 2, "num_workers": 1, "num_load_file": 1,
          "num_steps": 4, "time_shift": 2, "max_labels": 8, "seed": 7,
          **kw}
    ours = PropheseeDataModule(**kw).loader(split)
    theirs = JDataModule(**kw).loader(split)
    label_dim = 5 if kw.get("one_label", True) else 6
    seen_labels = edge = 0
    for _ in range(BATCHES):
        (x, lab), (jx, jlab) = next(ours), next(theirs)
        assert x.dtype == jx.dtype == np.uint8
        assert x.shape == jx.shape == (4, kw["batch_size"],
                                       *(x.shape[2:4]), 2)
        assert lab.shape == jlab.shape == (kw["batch_size"], 8, label_dim)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(lab, jlab)
        seen_labels += int((lab[..., -1] >= 0).sum())
        edge += int(x[:, :, :, -1].sum())
        assert x.any()
    assert seen_labels > 0
    if setup == "1mpx_st_clip":
        # the events past the edge were clipped onto the last column
        assert edge > 1000
    ours.close()
    theirs.close()


def test_loader_close_joins_its_workers(gen1):
    before = set(threading.enumerate())
    dm = PropheseeDataModule(data_dir=gen1, batch_size=2, num_workers=3,
                             num_load_file=1, num_steps=4, time_shift=2)
    it = dm.train_loader()
    next(it)
    workers = set(threading.enumerate()) - before
    assert len(workers) == 3
    it.close()
    assert not any(t.is_alive() for t in workers)


def test_loader_raises_a_worker_error(tmp_path):
    dm = PropheseeDataModule(data_dir=str(tmp_path), num_workers=2)
    with pytest.raises(RuntimeError, match="does not contain data"):
        next(dm.train_loader())


def test_multi_host_sharding_raises(gen1):
    """Host sharding is taken (``test_host_sharded_loader_bit_equal_to_jax``);
    a host id outside ``[0, num_hosts)`` raises."""
    for host_id in (-1, 2):
        with pytest.raises(ValueError, match="host_id"):
            PropheseeDataModule(data_dir=gen1, host_id=host_id, num_hosts=2)
    dm = PropheseeDataModule(data_dir=gen1, host_id=1, num_hosts=2)
    assert (dm.host_id, dm.num_hosts) == (1, 2)


@pytest.fixture(scope="module")
def gen1_two(tmp_path_factory):
    """Two recordings a split: one for each of two hosts."""
    root = str(tmp_path_factory.mktemp("gen1_two"))
    return make_synthetic_dataset(root, records_per_split=2,
                                  duration_ms=1200)


@pytest.mark.parametrize("host_id", [0, 1])
def test_host_sharded_loader_bit_equal_to_jax(gen1_two, host_id):
    """``PropheseeDataModule(host_id=h, num_hosts=2)`` (a rank's shard of
    the files under data parallel) gives JAX's module's batches at the
    same ``(host_id, num_hosts)``, bit for bit; the two hosts read
    different files."""
    kw = dict(data_dir=gen1_two, batch_size=2, num_workers=1,
              num_load_file=1, num_steps=4, time_shift=2, max_labels=8,
              seed=3, num_hosts=2)
    ours = PropheseeDataModule(host_id=host_id, **kw).train_loader()
    theirs = JDataModule(host_id=host_id, **kw).train_loader()
    other = PropheseeDataModule(host_id=1 - host_id, **kw).train_loader()
    try:
        for _ in range(BATCHES):
            (x, lab), (jx, jlab) = next(ours), next(theirs)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(lab, jlab)
            assert x.any()
        assert not np.array_equal(next(other)[0], next(ours)[0])
    finally:
        for it in (ours, theirs, other):
            it.close()


def test_event_reader_matches_jax(gen1):
    path = os.path.join(gen1, "gen1", "train", "rec0_td.dat")
    ours, theirs = EventReader(path), JReader(path)
    assert ours.n_events == theirs.n_events > 4096
    # JAX decodes in numpy under 4096 records and natively above; the
    # port decodes every slice natively
    for dt in (1_000, 50_000, 200_000, 10 ** 7):
        calls = bindings.COUNTS["decode_events"]
        a, b = ours.load_delta_t(dt), theirs.load_delta_t(dt)
        assert bindings.COUNTS["decode_events"] == calls + 1
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert ours.current_time == theirs.current_time
    assert ours.done and theirs.done


# ---- the native kernels against their numpy versions ----

def _records(n, seed, t_max=100_000, x_max=400, y_max=300):
    """Records with times on both sides of the windows below, x and y
    past GEN1's edges and spare bits above the polarity bit."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, t_max, n)).astype(np.uint32)
    x = rng.integers(0, x_max, n).astype(np.uint32)
    y = rng.integers(0, y_max, n).astype(np.uint32)
    word = x | (y << 14) | (rng.integers(0, 16, n).astype(np.uint32) << 28)
    return np.stack([t, word], axis=1).astype("<u4")


@pytest.mark.parametrize("n", [0, 100, 5000])
def test_decode_bit_equal_to_numpy(n):
    rec = _records(n, n)
    calls = bindings.COUNTS["decode_events"]
    got = bindings.decode_events(rec)
    want = bindings.decode_events_reference(rec)
    assert bindings.COUNTS["decode_events"] == calls + 1
    for k in "txyp":
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert n == 0 or got["p"].max() == 1


@pytest.mark.parametrize("clip_x", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("case", ["window", "empty", "all_outside"])
def test_rasterize_bit_equal_to_numpy(case, dtype, clip_x):
    rec = {"window": _records(20_000, 1), "empty": _records(0, 0),
           "all_outside": _records(3000, 2, t_max=9_000)}[case]
    t_min, step, steps = 10_000, 4_000, 6  # the window is [10, 34) ms
    calls = bindings.COUNTS["rasterize_records"]
    frames, n = bindings.rasterize_records(rec, t_min, step, steps,
                                           *GEN1_HW, clip_x, dtype)
    assert bindings.COUNTS["rasterize_records"] == calls + 1
    want, want_n = bindings.rasterize_records_reference(
        rec, t_min, step, steps, *GEN1_HW, clip_x, dtype)
    assert frames.dtype == want.dtype == np.dtype(dtype)
    assert frames.shape == want.shape == (steps, *GEN1_HW, 2)
    assert n == want_n
    np.testing.assert_array_equal(frames, want)
    if case == "window":
        t = rec[:, 0].astype(np.int64)
        assert 0 < n < len(rec)
        assert n == int(((t >= t_min) & (t < t_min + step * steps)).sum())
        x = rec[:, 1] & 0x3FFF
        clipped = frames[..., GEN1_HW[1] - 1, :].sum()
        unclipped = bindings.rasterize_records(
            rec, t_min, step, steps, *GEN1_HW, False, dtype)[0]
        # the clip piles the events past the edge onto the last column
        assert (x >= GEN1_HW[1]).any()
        assert (clipped > unclipped[..., GEN1_HW[1] - 1, :].sum()) == clip_x
    else:
        assert n == 0 and not frames.any()


def test_rasterize_refuses_other_dtypes():
    for fn in (bindings.rasterize_records,
               bindings.rasterize_records_reference):
        with pytest.raises(ValueError, match="unsupported frame dtype"):
            fn(_records(10, 0), 0, 1000, 2, 8, 8, dtype=np.float16)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ .*bad.cc failed"):
        bindings.build_library(str(bad), str(tmp_path / "libbad.so"))
    assert not (tmp_path / "libbad.so").exists()
    monkeypatch.setenv("PATH", str(tmp_path))  # no compiler on the path
    with pytest.raises(RuntimeError, match="g\\+\\+ could not run"):
        bindings.build_library(bindings.SOURCE, str(tmp_path / "lib.so"))


def test_library_rebuilt_when_the_source_is_newer(tmp_path):
    src = tmp_path / "event_ops.cc"
    shutil.copy(bindings.SOURCE, src)
    lib = str(tmp_path / "build" / "libevent_ops.so")
    bindings.build_library(str(src), lib)
    built = os.path.getmtime(lib)
    bindings.build_library(str(src), lib)
    assert os.path.getmtime(lib) == built  # current: not rebuilt
    os.utime(lib, (built - 10, built - 10))  # now older than the source
    bindings.build_library(str(src), lib)
    assert os.path.getmtime(lib) >= built


def test_the_library_loads_from_the_build_directory():
    bindings.decode_events(_records(1, 0))
    assert bindings.COUNTS["loads"] == 1
    assert os.path.exists(bindings.LIBRARY)
    assert os.path.dirname(bindings.LIBRARY).endswith(
        os.path.join("build", "native"))


# ---- four Adamax steps on loader batches ----

def test_adamax_on_loader_batches_matches_jax(gen1, tmp_path):
    """JAX's jitted train step (Adamax, per-step schedule) on its
    loader's batches against the port's ``train_step`` on the port
    loader's batches, from the same weights; for each step a JAX key is
    taken whose draw is the start r given to the port (0, 1, 0, 1)."""
    window, steps, batch = 2, 4, 2
    jm = JNarrow(num_classes=2, in_hw=GEN1_HW, time_window=window)
    params, stats = _jax_weights(jm, 0, 8.0)
    pm = PNarrow(num_classes=2, in_hw=GEN1_HW, time_window=window,
                 device="cpu")
    load_jax_params(pm, params, stats)
    kw = dict(data_dir=gen1, batch_size=batch, num_workers=1,
              num_load_file=1, num_steps=6, time_shift=2, max_labels=8,
              seed=0)
    ours = PropheseeDataModule(**kw).train_loader()
    theirs = JDataModule(**kw).train_loader()

    jt = JTrainer(out_dir=str(tmp_path / "jax"), seed=0, prefetch_batches=0)
    jt.mesh_for_batch(batch)
    opt, jit_train, _ = jt._build_steps(jm, False)
    opt_state = opt.init(params)
    keys, starts, k = [], [], 0
    while len(keys) < steps:
        want = len(keys) % window
        key = jax.random.PRNGKey(k)
        k += 1
        if int(jax.random.randint(key, (), 0, window)) == want:
            keys.append(key)
            starts.append(want)
    trainer = Trainer(seed=0)
    trainer.configure(pm)
    j_losses, losses = [], []
    for s in range(steps):
        (x, lab), (jx, jlab) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, jx)
        Xd, labd = shard_batch(jt.mesh, jnp.asarray(jx), jnp.asarray(jlab))
        params, opt_state, stats, _, loss = jit_train(
            params, opt_state, stats, None, Xd, labd, keys[s])
        j_losses.append(float(loss))
        losses.append(float(trainer.train_step(
            pm, torch.from_numpy(x), torch.from_numpy(lab), starts[s])))
    ours.close()
    theirs.close()
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert len(set(np.round(j_losses, 5))) == steps  # the steps differ


@pytest.mark.parametrize("shape", [(10,), (10, 3), (2, 2, 2)])
def test_native_kernels_refuse_records_of_another_shape(shape):
    bad = np.zeros(shape, np.uint32)
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        bindings.decode_events(bad)
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        bindings.rasterize_records(bad, 0, 1000, 2, 8, 8)
    with pytest.raises(ValueError, match="step_us must be positive"):
        bindings.rasterize_records(_records(4, 0), 0, 0, 2, 8, 8)
