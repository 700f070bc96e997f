"""DM-NeRF's object manipulation in plain float32 PyTorch (arXiv:2208.07227
§3.3; the authors' networks/manipulator.py, `exchanger` and `manipulator`):
an object is moved at render time, with no retraining, by querying the
field along target rays, the original rays moved by the object's inverse
motion (a rigid object's target rays are the rays of the target pose,
transform @ pose), and swapping raw samples between the original and the
target rays by their instance labels.

In each block of rays, for the original rays and each moved object's target
rays alike:
1. the coarse pass: the coarse field at N_samples linear depths;
2. the accumulated labels: N_importance depths from the coarse weights, the
   fine field on the sorted union of both sets of depths, composited: the
   ray's instance map (sigmoid, the air channel kept).
Then on the original rays:
3. the exchanger on the coarse samples, their weights again, and
   N_importance depths from those;
4. the fine pass: the fine field on the sorted union of the coarse depths,
   the depths of step 3 and every object's depths of step 2, on the original
   rays and on each object's target rays; the exchanger on those samples;
   the composite: rgb and the instance map.

The exchanger, for each moved object in turn (label m); a point's label is
the argmax of its K+1 instance logits, a ray's the argmax of its accumulated
map without the air channel:
- occlusion fix: a point labelled m on a ray whose label is not m takes the
  ray's label, on the original rays and on the target rays;
- filling: an original ray labelled m whose point is not labelled m;
- exchange: where the target's point is labelled m, or at a filling, the
  original sample is replaced by the target's;
- elimination: where the original point is labelled m and the target's is
  not, the original sample is zeroed.
The original rays' point labels carry their fixes from one object to the
next; the samples are replaced in place, one object after another.

Departures from the authors' code:
- the importance depths are the deterministic inverse CDF (u evenly spaced,
  render.py::importance); the authors' manipulator draws them at random even
  at test time, so no two of its renders agree;
- a point's label is the argmax of its logits, where the authors' code takes
  it of their sigmoid: the same label, except where float32's sigmoid
  rounds two logits above ~17 to 1.0 and the first of the tie wins;
- the authors sort the fine union once per target from that target's coarse
  depths; the targets' coarse depths are the original rays' (the same
  linear depths), so here the one union serves every ray set.

`quantize` rounds both operands of every product of the fields as in
field.py: None (float32), "bf16" or "fp8".
"""

from __future__ import annotations

import torch

from benchmark.reference.render import importance, linear_depths, run_field, view_rays, weights_of


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor) -> dict:
    """rgb [R, 3] and the instance map [R, K+1] (sigmoid, air kept) of raw
    [R, S, C] at depths z."""
    w = weights_of(raw[..., 3], z, rays_d)
    return {"rgb": torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=-2),
            "ins": torch.sigmoid(torch.sum(w[..., None] * raw[..., 4:], dim=-2)),
            "weights": w}


def exchanger(ori_raw: torch.Tensor, tar_raws, ori_ins: torch.Tensor, tar_inss,
              move_labels) -> torch.Tensor:
    """The original samples [R, S, C] after every object's exchange."""
    out = ori_raw.clone()
    ori_point = ori_raw[..., 4:].argmax(-1)
    ori_ray = ori_ins[:, :-1].argmax(-1)[:, None].expand_as(ori_point)
    for tar_raw, tar_ins, m in zip(tar_raws, tar_inss, move_labels):
        occluded = (ori_ray != m) & (ori_point == m)
        ori_point[occluded] = ori_ray[occluded]
        filling = (ori_point != m) & (ori_ray == m)
        tar_point = tar_raw[..., 4:].argmax(-1)
        tar_ray = tar_ins[:, :-1].argmax(-1)[:, None].expand_as(tar_point)
        occluded = (tar_ray != m) & (tar_point == m)
        tar_point[occluded] = tar_ray[occluded]
        exchange = (tar_point == m) | filling
        eliminate = (ori_point == m) & (tar_point != m)
        out[exchange] = tar_raw[exchange]
        out[eliminate] = 0.0
    return out


def edit_block(w_coarse: dict, w_fine: dict, cfg: dict, ori, tars, move_labels,
               quantize=None) -> dict:
    """One block of rays: ori (rays_o, rays_d) [R, 3] each, tars one such
    pair per moved object. rgb [R, 3] and ins [R, K+1] (sigmoid, air kept)."""
    near, far = float(cfg["near"]), float(cfg["far"])
    n_s, n_i = int(cfg["N_samples"]), int(cfg["N_importance"])
    rays_o, rays_d = ori
    z = linear_depths(rays_o.shape[0], near, far, n_s, rays_o.device)
    coarse, accum, depths = [], [], []
    for o, d in [ori] + list(tars):
        raw = run_field(w_coarse, cfg, o, d, z, quantize)
        zs = importance(z, weights_of(raw[..., 3], z, d), n_i)
        zf, _ = torch.sort(torch.cat([z, zs], -1), -1)
        accum.append(composite(run_field(w_fine, cfg, o, d, zf, quantize), zf, d)["ins"])
        coarse.append(raw)
        depths.append(zs)
    raw_x = exchanger(coarse[0], coarse[1:], accum[0], accum[1:], move_labels)
    zs2 = importance(z, weights_of(raw_x[..., 3], z, rays_d), n_i)
    z2, _ = torch.sort(torch.cat([z, zs2] + depths[1:], -1), -1)
    fine = [run_field(w_fine, cfg, o, d, z2, quantize) for o, d in [ori] + list(tars)]
    final = exchanger(fine[0], fine[1:], accum[0], accum[1:], move_labels)
    out = composite(final, z2, rays_d)
    return {"rgb": out["rgb"], "ins": out["ins"]}


@torch.no_grad()
def edit_rays(w_coarse: dict, w_fine: dict, cfg: dict, ori, tars, move_labels,
              block: int = 4096, quantize=None) -> dict:
    """The edit of a whole set of rays, in blocks: rgb [R, 3], ins [R, K+1],
    label_full [R] (the argmax over every channel), label [R] and conf [R]
    (the argmax and max without the air channel)."""
    n = ori[0].shape[0]
    outs = []
    for s in range(0, n, block):
        sl = slice(s, s + block)
        outs.append(edit_block(w_coarse, w_fine, cfg, (ori[0][sl], ori[1][sl]),
                               [(o[sl], d[sl]) for o, d in tars], move_labels, quantize))
    rgb = torch.cat([o["rgb"] for o in outs])
    ins = torch.cat([o["ins"] for o in outs])
    conf, label = torch.max(ins[:, :-1], dim=-1)
    return {"rgb": rgb, "ins": ins, "label_full": torch.argmax(ins, dim=-1), "label": label,
            "conf": conf}


def edit_view(w_coarse: dict, w_fine: dict, cfg: dict, K: torch.Tensor, c2w: torch.Tensor,
              tar_c2ws, move_labels, block: int = 4096, quantize=None) -> dict:
    """edit_rays of a whole view from the pose c2w, one rigid object moved
    per target pose in tar_c2ws (its target rays are those of the target
    pose), row-major over the H x W pixels."""
    H, W = int(cfg["H"]), int(cfg["W"])
    ori = view_rays(H, W, K, c2w)
    tars = [view_rays(H, W, K, t) for t in tar_c2ws]
    return edit_rays(w_coarse, w_fine, cfg, ori, tars, move_labels, block, quantize)
