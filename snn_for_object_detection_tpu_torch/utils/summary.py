"""Model summary: parameter and per-frame conv FLOP count.

Counterpart of ``snn_for_object_detection_tpu/utils/summary.py`` (the
analogue of Lightning's ``ModelSummary`` callback): the same walk over
the model's layer specs, counting ``2*k*k*Cin*Cout*H'*W'`` a conv (and
a ConvLSTM's gate conv) a frame, so that a rate can be stated against a
count of the work; the parameters are the port's own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from snn_for_object_detection_tpu_torch.models import spec as S


def _walk_cfg(cfgs, in_ch, in_hw, rows: List[Tuple[str, int, tuple]],
              prefix=""):
    """Shape inference over a config, recording each conv's FLOPs."""
    if isinstance(cfgs, (S.Residual, S.Dense)):
        mode = "R" if isinstance(cfgs, S.Residual) else "D"
        outs = [_walk_cfg(branch, in_ch, in_hw, rows, f"{prefix}/{mode}{bi}")
                for bi, branch in enumerate(cfgs)]
        if mode == "R":
            return outs[0]
        return sum(o[0] for o in outs), outs[0][1]
    ch, hw = in_ch, in_hw
    for li, el in enumerate(cfgs):
        if isinstance(el, (list, tuple)):
            ch, hw = _walk_cfg(el, ch, hw, rows, f"{prefix}/{li}")
        elif isinstance(el, S.Conv):
            out = ch if el.out_channels is None else el.out_channels
            k, s = el.kernel_size, el.stride
            pad = k // 2
            oh = (hw[0] + 2 * pad - k) // s + 1
            ow = (hw[1] + 2 * pad - k) // s + 1
            rows.append((f"{prefix}/conv{li}", 2 * k * k * ch * out * oh * ow,
                         (out, oh, ow)))
            ch, hw = out, (oh, ow)
        elif isinstance(el, S.LSTM):
            hidden = ch if el.hidden_size is None else el.hidden_size
            k = el.kernel_size
            rows.append(
                (f"{prefix}/lstm{li}",
                 2 * k * k * (ch + hidden) * 4 * hidden * hw[0] * hw[1],
                 (hidden, *hw))
            )
            ch = hidden
        elif isinstance(el, S.Pool):
            k = el.kernel_size
            s = el.stride if el.stride is not None else k
            hw = ((hw[0] - k) // s + 1, (hw[1] - k) // s + 1)
        elif isinstance(el, S.Up):
            hw = (hw[0] * el.scale, hw[1] * el.scale)
    return ch, hw


def summarize(model) -> Dict:
    """``{params, conv_flops_per_frame, rows}`` of a ``SODa`` model;
    ``rows`` are ``(name, FLOPs, output shape)`` a conv."""
    rows: List[Tuple[str, int, tuple]] = []
    ch, hw = _walk_cfg(model.backbone_cfgs(), model.in_channels,
                       model.in_hw, rows, "backbone")
    _walk_cfg(model.neck_cfgs(), ch, hw, rows, "neck")
    head_cfg = model.head_cfgs(model.num_box_out, model.num_class_out)
    for idx, (hch, hhw) in enumerate(model.neck_out_shape):
        c2, w2 = _walk_cfg(head_cfg[0], hch, hhw, rows, f"head{idx}/base")
        _walk_cfg(head_cfg[1], c2, w2, rows, f"head{idx}/box")
        _walk_cfg(head_cfg[2], c2, w2, rows, f"head{idx}/cls")
    return {
        "params": int(sum(p.numel() for p in model.parameters())),
        "conv_flops_per_frame": int(sum(r[1] for r in rows)),
        "rows": rows,
    }


def print_summary(model) -> None:
    s = summarize(model)
    print(f"params: {s['params']:,}")
    print(f"conv FLOPs/frame: {s['conv_flops_per_frame'] / 1e9:.2f} G")
    top = sorted(s["rows"], key=lambda r: -r[1])[:10]
    for name, fl, shape in top:
        print(f"  {name:<40} {fl/1e6:9.1f} M  out={shape}")
