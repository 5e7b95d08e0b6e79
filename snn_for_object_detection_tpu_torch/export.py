"""``torch.export`` of the streaming predict step (deployment).

Counterpart of ``snn_for_object_detection_tpu/export.py``. The one-frame
predict program (weights, folded statistics, anchors and the detection
decode baked in) is traced by ``torch.export`` and written to a single
file that holds one program per platform. A serving process loads it and
runs frames with no model code, config or checkpoint loading:

    export_predict(model, "predict.pt2", platforms=("cuda",))
    ...
    runner = load_predict("predict.pt2")   # any process, on the card
    dets = runner(frame)                   # [B, 300, 6]; carries state

The recurrent neuron state is threaded as flat tensors in and out of the
program; :class:`_Runner` zero-initialises it on the first frame and
carries it across calls.

The one difference from JAX's blob: a CUDA program calls the cell
kernels as the registered operators ``soda_torch::temporal_cell_seq``
and ``soda_torch::plif_cell_seq``. So the serving process needs, besides
the file, ``torch`` and the port's op library (``ops/`` with
``csrc/``): :func:`load_predict` imports ``ops/cuda_kernels.py``, which
registers the operators, and the kernels build from ``csrc/`` into
``build/kernels/`` at their first launch. Nothing of ``models/``,
``train/``, ``data/`` or ``serve`` is imported. A CPU program holds the
kernels' plain versions and calls no registered operator.

Each platform is traced on its own device, since the port picks a
kernel or its plain version by the tensors' device at trace time: a
CUDA program needs a card to export and to load, and asking for one on
a host without a card raises.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import zipfile
from typing import Any, Dict, List

import torch
from torch.utils import _pytree

# registers soda_torch::temporal_cell_seq and soda_torch::plif_cell_seq,
# which a CUDA program calls
from snn_for_object_detection_tpu_torch.ops import cuda_kernels

FORMAT = "snn_for_object_detection_tpu_torch.export/1"
EXAMPLE_BATCH = 2  # torch.export specialises a traced size of 0 or 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: the CUDA program calls the cell kernels, so it is "
            "traced and run on a card, and no CUDA device is available "
            "here; use platforms=('cpu',) / device='cpu'")


@contextlib.contextmanager
def _no_stack_traces():
    """No stack trace recorded a node while tracing, where torch has the
    switch: the file does not need them, and recording them takes a good
    part of the trace's host time."""
    cfg = torch.fx.config
    saved = getattr(cfg, "do_not_emit_stack_traces", None)
    if saved is None:
        yield
        return
    cfg.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        cfg.do_not_emit_stack_traces = saved


class _Predict(torch.nn.Module):
    """``model.predict`` on one frame and the state as flat leaves:
    ``(frame, leaves) -> (dets, *new leaves)``, as JAX's ``fn``."""

    def __init__(self, model, treedef):
        super().__init__()
        self.model = model
        self.treedef = treedef

    def forward(self, x: torch.Tensor, leaves: List[torch.Tensor]):
        state = _pytree.tree_unflatten(list(leaves), self.treedef)
        dets, new_state = self.model.predict(x, state)
        return (dets, *_pytree.tree_leaves(new_state))


def _trace(model, device: torch.device, batch_size):
    """One platform's ``ExportedProgram`` and the leaves' specs: the model
    moved to ``device`` (a deep copy when it lives elsewhere)."""
    if model.device.type != device.type:
        model = copy.deepcopy(model).to(device)
        model.device = device
    b = EXAMPLE_BATCH if isinstance(batch_size, str) else batch_size
    leaves, treedef = _pytree.tree_flatten(model.init_state(b))
    h, w = model.in_hw
    x = torch.zeros((b, h, w, model.in_channels), dtype=torch.uint8,
                    device=device)
    if isinstance(batch_size, str):
        bdim = torch.export.Dim(batch_size, min=1)
        dynamic = {"x": {0: bdim}, "leaves": [{0: bdim} for _ in leaves]}
    else:
        dynamic = None
    # an outer no_grad: predict's own decorator would leave
    # set_grad_enabled nodes that torch.export.save refuses
    with torch.no_grad(), _no_stack_traces():
        program = torch.export.export(
            _Predict(model, treedef), (x, leaves), dynamic_shapes=dynamic,
            strict=False)
    specs = [{"shape": [None if isinstance(batch_size, str) else b,
                        *l.shape[1:]], "dtype": _dtype_name(l.dtype)}
             for l in leaves]
    return program, specs


def export_predict(model, path: str, batch_size: int | str = "b",
                   platforms=("cpu", "cuda")) -> None:
    """Serialize ``model.predict`` (one frame + carried state) with the
    model's weights, folded statistics and anchors baked in, one program
    for each platform in ``platforms`` (``"cpu"``, ``"cuda"``), all in
    the one file ``path``. ``batch_size`` may be an int (a fixed-shape
    program) or a dimension name like ``"b"`` (a symbolic batch: one
    file serves any camera count). Each platform is traced on its own
    device (the CUDA program on the card, which it needs). Returns
    nothing; writes ``path``."""
    platforms = tuple(platforms)
    unknown = sorted(set(platforms) - {"cpu", "cuda"})
    if unknown or not platforms:
        raise ValueError(f"platforms {platforms}: each one of 'cpu', "
                         "'cuda', at least one")
    if "cuda" in platforms:
        _require_card("export_predict(platforms=('cuda', ...))")
    h, w = model.in_hw
    manifest: Dict[str, Any] = {
        "format": FORMAT, "platforms": list(platforms),
        "frame": [None if isinstance(batch_size, str) else batch_size,
                  h, w, model.in_channels],
    }
    blobs = {}
    for platform in platforms:
        program, manifest["state"] = _trace(
            model, torch.device(platform), batch_size)
        # the example state would be saved beside the weights (at GEN1
        # four times their size); the manifest describes the inputs
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[platform] = buf.getvalue()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        for platform, blob in blobs.items():
            z.writestr(f"{platform}.pt2", blob)


class _Runner:
    """Loaded predict program + carried recurrent state."""

    def __init__(self, program, manifest: Dict[str, Any],
                 device: torch.device):
        self._program = program.module()
        self._state_specs = manifest["state"]
        self.device = device
        self.state = None

    def reset(self) -> None:
        """Zero the recurrent state (stream gap / new camera)."""
        self.state = None

    def _zeros(self, spec, b: int) -> torch.Tensor:
        shape = [b if d is None else d for d in spec["shape"]]
        return torch.zeros(shape, dtype=getattr(torch, spec["dtype"]),
                           device=self.device)

    def __call__(self, frame: Any) -> torch.Tensor:
        """frame [B, H, W, C] uint8 (numpy or a tensor) -> detections
        [B, 300, 6] (class, conf, x1, y1, x2, y2; class -1 = padding),
        on the runner's device.

        The batch axis is the set of live streams; changing B would
        invalidate every stream's carried state, so a mid-stream B
        change raises: call :meth:`reset` first (or manage slot
        re-packing externally, e.g. via ``serve.StreamingEngine``)."""
        frame = torch.as_tensor(frame).to(self.device, torch.uint8)
        if self.state is None:
            self.state = [self._zeros(s, frame.shape[0])
                          for s in self._state_specs]
        elif self.state[0].shape[0] != frame.shape[0]:
            raise ValueError(
                f"batch changed {self.state[0].shape[0]} -> "
                f"{frame.shape[0]} mid-stream; this would silently "
                "zero every stream's recurrent state — call reset() "
                "to start over, or keep the batch constant"
            )
        # the model's convs run under this flag (models/compile.py); the
        # traced program holds the convs, not the flag
        with torch.no_grad(), cuda_kernels.full_fp32_conv():
            out = self._program(frame, self.state)
        self.state = list(out[1:])
        return out[0]


def load_predict(path: str, device="cuda") -> _Runner:
    """Load the ``device``'s program of a file written by
    :func:`export_predict` (``"cuda"``, the default, or ``"cpu"``); no
    model code, config or checkpoint needed. A CUDA program needs a card:
    there is no CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        _require_card(f"load_predict({path!r}, device={str(device)!r})")
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not a file of export_predict")
        if device.type not in manifest["platforms"]:
            raise ValueError(
                f"{path} holds programs for {manifest['platforms']}, not "
                f"{device.type!r}: export it with that platform")
        blob = z.read(f"{device.type}.pt2")
    return _Runner(torch.export.load(io.BytesIO(blob)), manifest, device)
