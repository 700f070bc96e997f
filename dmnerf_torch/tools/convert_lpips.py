"""Convert LPIPS-VGG weights into the .npz layout that eval/lpips.py (and the
JAX package's eval/lpips_jax.py) loads: a copy of tools/convert_lpips.py, so
one converted file serves both packages.

No `lpips` / `torchvision` import is needed: inputs are raw torch state_dict
files (torch.load + key parsing only), so any of these work:

  (a) ONE full `lpips.LPIPS(net='vgg')` state_dict (torch.save(m.state_dict())):
        python -m dmnerf_torch.tools.convert_lpips --lpips lpips_full.pth --out lpips_vgg.npz
  (b) the torchvision VGG16 features state_dict + the lpips lin checkpoint
      (the `lpips/weights/v0.1/vgg.pth` file shipped in the pip package holds
      ONLY the lin heads; the backbone comes from torchvision):
        python -m dmnerf_torch.tools.convert_lpips --vgg vgg16_features.pth --lin vgg.pth \
            --out lpips_vgg.npz

Expected keys (any one naming scheme per conv):
- conv i (torchvision features index ti in VGG16_CONV_IDX):
    '{ti}.weight'                  vgg16(...).features.state_dict()
    'features.{ti}.weight'         full vgg16().state_dict()
    'net.slice{s}.{ti}.weight'     lpips.LPIPS full state_dict (slices keep
                                   the original feature indices as names)
  shape [cout, cin, 3, 3] per VGG16_CONV_SHAPES; bias key = same with .bias.
- lin head k: 'lin{k}.model.1.weight' (or 'lins.{k}.model.1.weight'),
  shape [1, C, 1, 1] with C in LIN_CHANNELS.

Output npz keys: conv{i}_w [3,3,cin,cout] (HWIO), conv{i}_b [cout],
lin{k}_w [C] (clamped nonnegative, as lpips does at load).
"""

import argparse
import re

import numpy as np
import torch

# torchvision vgg16.features conv layer indices (pools at 4, 9, 16, 23, 30)
VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_CH = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
       (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
       (512, 512), (512, 512)]
VGG16_CONV_SHAPES = [(co, ci, 3, 3) for ci, co in _CH]
LIN_CHANNELS = [64, 128, 256, 512, 512]


def _to_numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _find(sd, patterns, what):
    for key in sd:
        for pat in patterns:
            if re.fullmatch(pat, key):
                return _to_numpy(sd[key])
    raise KeyError(
        f"no key for {what}: tried patterns {patterns} against "
        f"{sorted(sd)[:8]}{'...' if len(sd) > 8 else ''}")


def convert_state_dicts(vgg_sd: dict, lin_sd: dict) -> dict:
    """Pure converter: (backbone state_dict, lin state_dict) -> npz dict.
    Both may be the same dict (full lpips.LPIPS state_dict). Validates every
    shape against the VGG16 contract before converting."""
    out = {}
    for ci, ti in enumerate(VGG16_CONV_IDX):
        pats = [rf"{ti}\.weight", rf"features\.{ti}\.weight",
                rf"net\.slice\d\.{ti}\.weight"]
        w = _find(vgg_sd, pats, f"conv{ci} weight")
        b = _find(vgg_sd, [p.replace("weight", "bias") for p in pats],
                  f"conv{ci} bias")
        want = VGG16_CONV_SHAPES[ci]
        if tuple(w.shape) != want or tuple(b.shape) != (want[0],):
            raise ValueError(f"conv{ci} (features.{ti}): got weight "
                             f"{tuple(w.shape)} bias {tuple(b.shape)}, "
                             f"want {want} / ({want[0]},)")
        out[f"conv{ci}_w"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
        out[f"conv{ci}_b"] = b.astype(np.float32)
    for k, c in enumerate(LIN_CHANNELS):
        w = _find(lin_sd, [rf"lin{k}\.model\.1\.weight",
                           rf"lins\.{k}\.model\.1\.weight"], f"lin{k} weight")
        if w.size != c:
            raise ValueError(f"lin{k}: got {tuple(w.shape)} ({w.size} values), "
                             f"want {c} channels")
        # lpips clamps the 1x1 head weights nonnegative at load time
        out[f"lin{k}_w"] = np.maximum(w.reshape(-1), 0.0).astype(np.float32)
    return out


def convert_files(lpips_path=None, vgg_path=None, lin_path=None) -> dict:
    def load(p):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        return sd.get("state_dict", sd) if isinstance(sd, dict) else sd

    if lpips_path:
        full = load(lpips_path)
        return convert_state_dicts(full, full)
    return convert_state_dicts(load(vgg_path), load(lin_path))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lpips", help="full lpips.LPIPS(net='vgg') state_dict")
    ap.add_argument("--vgg", help="torchvision vgg16 features state_dict")
    ap.add_argument("--lin", help="lpips lin-heads checkpoint (vgg.pth)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not args.lpips and not (args.vgg and args.lin):
        ap.error("need --lpips OR both --vgg and --lin")

    out = convert_files(args.lpips, args.vgg, args.lin)
    np.savez(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays")


if __name__ == "__main__":
    main()
