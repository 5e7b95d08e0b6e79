"""The port's ``prefetch_to_device`` and ``shard_batch``, on the CPU.

The counterparts of tests/test_prefetch.py: order and placement on the
mesh's device, ``size=0`` synchronous, a loader's error raised at the
consumer's ``next()``, and ``close()`` stopping an infinite source (the
worker thread owns and closes it). Beside them: batches keep their
dtypes (uint8 frames, fp32 labels), the worker thread is gone after
``close()``, and JAX's ``prefetch_to_device`` yields the same batches in
the same order.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.parallel import (
    make_mesh as j_make_mesh,
    prefetch_to_device as j_prefetch_to_device,
)
from snn_for_object_detection_tpu_torch.parallel import (
    make_mesh,
    prefetch_to_device,
    shard_batch,
)

torch.set_num_threads(1)


def _batches(n, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise RuntimeError("loader exploded")
        yield (np.full((3, 2, 4, 4, 2), i, np.uint8),
               np.full((2, 5, 5), float(i), np.float64))


@pytest.fixture
def mesh():
    return make_mesh(["cpu"])


def test_prefetch_preserves_order_and_places_on_device(mesh):
    out = list(prefetch_to_device(_batches(5), mesh, size=2))
    assert len(out) == 5
    for i, (X, labels) in enumerate(out):
        assert isinstance(X, torch.Tensor) and isinstance(labels,
                                                          torch.Tensor)
        assert X.device == labels.device == mesh.device
        assert int(X[0, 0, 0, 0, 0]) == i
        assert X.dtype == torch.uint8 and labels.dtype == torch.float32


def test_prefetch_zero_size_is_synchronous(mesh):
    before = set(threading.enumerate())
    it = prefetch_to_device(_batches(3), mesh, size=0)
    first = next(it)
    assert set(threading.enumerate()) == before  # no thread
    out = [first, *it]
    assert [int(x[0, 0, 0, 0, 0]) for x, _ in out] == [0, 1, 2]


def test_prefetch_propagates_loader_errors(mesh):
    it = prefetch_to_device(_batches(10, fail_at=2), mesh, size=2)
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="loader exploded"):
        for _ in it:
            pass


@pytest.mark.parametrize("size", [0, 2])
def test_prefetch_close_stops_infinite_source(mesh, size):
    closed = []

    def infinite():
        try:
            for _ in itertools.count():
                yield (np.zeros((3, 2, 4, 4, 2), np.uint8),
                       np.zeros((2, 5, 5), np.float32))
        finally:
            closed.append(True)

    it = prefetch_to_device(infinite(), mesh, size=size)
    next(it)
    workers = [t for t in threading.enumerate()
               if t.name == "device-prefetch"]
    assert bool(workers) == (size > 0)
    it.close()
    # close() joins the worker, which owns and closes the source
    # generator on its way out (at size 0 the generator closes it)
    assert closed == [True]
    assert not any(t.is_alive() for t in workers)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_yields_jax_batches(mesh):
    """The same batches, in the same order, as JAX's prefetch on one
    device."""
    import jax

    ours = list(prefetch_to_device(_batches(4), mesh, size=2))
    theirs = list(j_prefetch_to_device(_batches(4),
                                       j_make_mesh(jax.devices()[:1]),
                                       size=2))
    for (x, lab), (jx, jlab) in zip(ours, theirs):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))


def test_shard_batch_and_mesh_shape(mesh):
    """A rank's batch on its device; a one-process mesh of one device is
    the data axis of size 1, of four CPU devices size 4 (serving), and a
    training mesh holds one device; four devices with ``spatial=2`` are
    two data rows of two (serving)."""
    X, lab = next(_batches(1))
    x, y = shard_batch(mesh, X, lab)
    assert torch.equal(x, torch.from_numpy(X))
    assert y.dtype == torch.float32
    assert mesh.shape == {"data": 1} and mesh.group is None
    four = make_mesh(["cpu"] * 4)
    assert four.size == 4
    with pytest.raises(ValueError, match="one device"):
        shard_batch(four, X, lab)
    # JAX's (data, space) serving mesh: a data row's first device holds
    # its slots
    grid = make_mesh(["cpu"] * 4, spatial=2)
    assert grid.shape == {"data": 2, "space": 2} and grid.size == 4
    assert len(grid.data_devices) == 2
    with pytest.raises(ValueError, match="3 devices not divisible by "
                                         "spatial=2"):
        make_mesh(["cpu"] * 3, spatial=2)
