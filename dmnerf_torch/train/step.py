"""The training step (port of dmnerf_tpu/train/step.py).

Mirrors the reference hot loop (train_dmsr.py:24-64): pick pixels of one
image, make their rays, render coarse -> fine (core/rendering.render_rays),
then the photometric loss, the Hungarian-matched instance loss
(losses/instance.py, matched on the host) and the emptiness penalizer, and
one Adam step. The scene's images, labels and poses live on the device.

The field is pluggable as in the JAX package: `pallas_train` (the default)
runs kernels/field.FusedField (K1 forward, K2 backward) on CUDA; False is the
plain autograd path through DMNeRFField (with `remat`, under activation
checkpointing). The plain path is an explicit choice, not a fallback.

Pixel samplers:
- "full": N_train pixels of one image, uniform without replacement
  (helpers.py:99-111).
- "crop" (ScanNet): 30% labeled-instance pixels, stacked LAST, and the rest
  uniform within the centre crop excluding the labeled picks (helpers.py:64-95,
  render.py:88-90). When an image has fewer labeled pixels than N_ins they are
  sampled with replacement (PARITY.md, "ScanNet crop sampler").

Randomness: each step draws from a torch.Generator on the device seeded from
(seed, step) (step_randomness), as make_train_scan_step's fold_in(base_key,
step) does, so a killed and resumed run replays bit for bit.

Under a ray mesh (parallel/mesh.py, mesh=DataMesh) every rank draws the
step's global randomness (the pixels, the jitter [N, S] and the inverse-CDF
uniforms [N, N_importance], in the order one rank draws them) and takes its
contiguous N/R rows of the rays and the noise; target_i stays whole and each
rank takes its rows of the instance-loss rays (the crop sampler's labeled
rays are the batch's last n_ins, so they sit on the last rank or ranks; a
rank with none contributes zeros). The losses are global (losses/*: psum),
the gradients are summed over the ranks after backward in one flat buffer,
and every rank takes the same Adam step. N_train must split over the ranks.

Under the 2-D mesh (mesh=Mesh2D, parallel/mesh.py::make_mesh_2d) the rays
split over its data axis as above, and the fields are tensor-parallel over
its model axis (parallel/model_parallel.py): create_train_state builds the
whole fields from the seed on every rank and keeps this rank's rows, so Adam
and its moments hold shards too. The loss statistics and the gradients are
summed over the data group only: the model ranks of a data row compute the
same loss, and each holds the whole gradient of its own rows. The plain path
runs ModelShardedField (column-parallel products); pallas_train runs K1/K2
on the weights gathered over the model group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dmnerf_torch.core.rays import rays_at_pixels
from dmnerf_torch.core.rendering import render_rays
from dmnerf_torch.core.sampling import z_val_sample
from dmnerf_torch.kernels.field import make_trainable_pallas_field
from dmnerf_torch.losses.emptiness import ins_penalizer
from dmnerf_torch.losses.instance import ins_criterion_pair
from dmnerf_torch.losses.photometric import img2mse, mse2psnr
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig, init_field_params
from dmnerf_torch.parallel.mesh import (Mesh2D, all_reduce_grads, data_axis, rank_share,
                                        shard_batch)
from dmnerf_torch.parallel.model_parallel import shard_params_model
from dmnerf_torch.train.schedule import make_optimizer
from dmnerf_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """Updated in place by the step."""
    params: Dict[str, DMNeRFField]          # {"coarse", "fine"} (or ModelShardedFields)
    opt: torch.optim.Adam
    sched: torch.optim.lr_scheduler.LambdaLR
    step: int                               # completed steps


class SceneArrays(NamedTuple):
    """Training data on the device."""
    images: torch.Tensor                    # [N, H, W, 3] f32 in [0, 1]
    labels: torch.Tensor                    # [N, H, W] int64
    poses: torch.Tensor                     # [N, 4, 4] f32 (c2w)
    K: torch.Tensor                         # [3, 3] f32
    labeled_idx: Optional[torch.Tensor] = None   # [N, max_lab] int64, padded
    labeled_cnt: Optional[torch.Tensor] = None   # [N] int64
    crop_idx: Optional[torch.Tensor] = None      # [n_crop] int64 flat pixel ids


def scene_arrays(scene, device) -> SceneArrays:
    """SceneData (host numpy) -> SceneArrays on `device` (the counterpart of
    SceneData.to_device_arrays)."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    labeled_idx = labeled_cnt = crop_idx = None
    if scene.ins_indices is not None:
        max_lab = max(max(len(ix) for ix in scene.ins_indices), 1)
        padded = np.zeros((len(scene.ins_indices), max_lab), np.int64)
        for i, ix in enumerate(scene.ins_indices):
            padded[i, :len(ix)] = ix
        labeled_idx = t(padded, torch.int64)
        labeled_cnt = t([len(ix) for ix in scene.ins_indices], torch.int64)
    if scene.crop_mask is not None:
        crop_idx = t(np.where(np.asarray(scene.crop_mask).reshape(-1) == 1)[0], torch.int64)
    return SceneArrays(t(scene.images, torch.float32), t(scene.gt_labels, torch.int64),
                       t(scene.poses, torch.float32), t(scene.K, torch.float32),
                       labeled_idx, labeled_cnt, crop_idx)


def create_train_state(seed: int, cfg: FieldConfig, lrate: float = 5e-4,
                       lrate_decay_k: int = 500, init_scheme: str = "he",
                       device="cpu", mesh: Optional[Mesh2D] = None) -> TrainState:
    """Two fields initialised from one CPU generator seeded with `seed`
    (coarse, then fine; init_scheme he or torch), and their Adam. Under a
    Mesh2D every rank builds the whole fields and keeps its rows
    (shard_params_model), so the shards hold the one-rank weights bit for
    bit."""
    gen = torch.Generator().manual_seed(seed)
    params = {"coarse": init_field_params(gen, cfg, init_scheme, device),
              "fine": init_field_params(gen, cfg, init_scheme, device)}
    if isinstance(mesh, Mesh2D):
        params = shard_params_model(params, mesh)
    opt, sched = make_optimizer(params, lrate, lrate_decay_k)
    return TrainState(params, opt, sched, 0)


def step_randomness(base_seed: int, step: int, n_images: int, device):
    """(position in i_train, torch.Generator on `device`) of step `step`: a
    pure function of (base_seed, step)."""
    s_img, s_gen = np.random.SeedSequence([base_seed, step]).generate_state(2, np.uint64)
    idx = int(np.random.default_rng(int(s_img)).integers(n_images))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s_gen))
    return idx, gen


def _select_pixels_full(gen: torch.Generator, H: int, W: int, n_train: int, device):
    return torch.randperm(H * W, generator=gen, device=device)[:n_train]


def _select_pixels_crop(gen: torch.Generator, scene: SceneArrays, img_i: int,
                        n_train: int, n_ins: int, n_pix: int):
    """-> (pixels [n_train] with the n_ins labeled ones last, labeled [n_ins])."""
    dev = scene.labeled_idx.device
    max_lab = scene.labeled_idx.shape[1]
    cnt = scene.labeled_cnt[img_i]
    ar = torch.arange(max_lab, device=dev)
    # a uniform permutation of the valid slots, invalid slots pushed to the end
    u = torch.rand(max_lab, generator=gen, device=dev) + (ar >= cnt).float() * 1e9
    order = torch.argsort(u)
    k = torch.arange(n_ins, device=dev)
    # fewer than n_ins labeled pixels: wrap around (with replacement)
    sel = torch.where(k < cnt, order[torch.clamp(k, max=max_lab - 1)],
                      order[k % torch.clamp(cnt, min=1)])
    lab_pix = scene.labeled_idx[img_i][sel]
    # the unlabeled pool is the crop without the labeled picks: the n_rgb
    # smallest random keys, with picked pixels' keys pushed up by 1e9
    flag = torch.zeros(n_pix, device=dev)
    flag[lab_pix] = 1.0
    keys = (torch.rand(scene.crop_idx.shape[0], generator=gen, device=dev)
            + flag[scene.crop_idx] * 1e9)
    pos = torch.topk(-keys, n_train - n_ins).indices
    return torch.cat([scene.crop_idx[pos], lab_pix]), lab_pix


def make_train_step(args, cfg: FieldConfig, sampler: str = "full", mesh=None):
    """step_fn(state, scene, gen, img_i) -> metrics (detached 0-d tensors);
    updates `state` in place. step_fn.loss_fn(params, rays_o, rays_d,
    target_c, target_i, gen, noise=None) -> (total, metrics) is the
    differentiable part (under a mesh, on this rank's rows). Its two halves:
    step_fn.draw(scene, gen, img_i) -> batch, and step_fn.update(state,
    batch, gen) -> metrics. mesh: a DataMesh, a Mesh2D (the state from
    create_train_state(..., mesh=mesh)) or None.

    args needs: N_train, N_samples, N_importance, near, far, perturb,
    penalize, tolerance, deta_w, ins_num, pallas_train, remat."""
    n_train = int(args.N_train)
    n_samples, n_importance = int(args.N_samples), int(args.N_importance)
    near, far = float(args.near), float(args.far)
    penalize = bool(args.penalize)
    perturb = float(args.perturb) > 0.0
    ins_num = int(args.ins_num)
    n_ins = int(n_train * 0.3) if sampler == "crop" else n_train
    model_parallel = isinstance(mesh, Mesh2D)
    mesh = data_axis(mesh)
    rank_share(n_train, mesh, "N_train")
    # the instance loss takes the batch's last n_ins rays: of this rank's
    # rows, those at or after ins_start, and their rows of target_i
    rows = mesh.rows(n_train) if mesh is not None else slice(0, n_train)
    ins_start = n_train - n_ins
    lo, hi = max(rows.start, ins_start), max(rows.stop, ins_start)
    ins_rows = slice(lo - rows.start, hi - rows.start)
    target_rows = slice(lo - ins_start, hi - ins_start)

    if getattr(args, "pallas_train", True):
        kernel_field = make_trainable_pallas_field(cfg)
        field = ((lambda m, pts, vd: kernel_field(m.gathered(), pts, vd)) if model_parallel
                 else kernel_field)
    elif getattr(args, "remat", False):
        field = lambda m, pts, vd: checkpoint(m, pts, vd, use_reentrant=False)
    else:
        field = lambda m, pts, vd: m(pts, vd)

    def loss_fn(params, rays_o, rays_d, target_c, target_i, gen, noise=None):
        coarse_fn = lambda pts, vd: field(params["coarse"], pts, vd)
        fine_fn = lambda pts, vd: field(params["fine"], pts, vd)
        with span("train.forward"):
            z_coarse = z_val_sample(rays_o.shape[0], near, far, n_samples, device=rays_o.device)
            out = render_rays(coarse_fn, fine_fn, rays_o, rays_d, z_coarse, n_importance,
                              generator=gen, perturb=perturb, noise=noise)

        with span("train.loss"):
            rgb_loss_c = img2mse(out["rgb_coarse"], target_c, mesh)
            rgb_loss_f = img2mse(out["rgb_fine"], target_c, mesh)
            # the penalizers need no assignment, so they are queued before
            # the instance loss waits for the device (its copy to the host)
            penalties = [ins_penalizer(out[f"raw_{sfx}"], out[f"z_vals_{sfx}"],
                                       out[f"depth_{sfx}"], rays_d,
                                       args.tolerance, args.deta_w, mesh)
                         for sfx in ("coarse", "fine")] if penalize else []
            loss_c, loss_f = ins_criterion_pair(
                out["ins_coarse"][ins_rows], out["ins_fine"][ins_rows], target_i, ins_num,
                logits_coarse=out["ins_logits_coarse"][ins_rows],
                logits_fine=out["ins_logits_fine"][ins_rows], mesh=mesh, n_rays=n_ins)
            rgb_loss = rgb_loss_f + rgb_loss_c
            ins_loss = loss_f.total + loss_c.total
            total = rgb_loss + ins_loss
            for penalty in penalties:
                total = total + penalty
            metrics = {"psnr_fine": mse2psnr(rgb_loss_f), "psnr_coarse": mse2psnr(rgb_loss_c),
                       "rgb_loss": rgb_loss, "ins_loss": ins_loss, "total_loss": total}
        return total, metrics

    def draw(scene: SceneArrays, gen: torch.Generator, img_i: int):
        """The step's batch (rays_o, rays_d, target_c, target_i, noise): its
        pixels of image img_i, their rays and targets, this rank's rows."""
        H, W = scene.images.shape[1:3]
        if sampler == "crop":
            pix, lab_pix = _select_pixels_crop(gen, scene, img_i, n_train, n_ins, H * W)
            target_i = scene.labels[img_i].reshape(-1)[lab_pix]
        else:
            pix = _select_pixels_full(gen, H, W, n_train, scene.images.device)
            target_i = scene.labels[img_i].reshape(-1)[pix]
        rays_o, rays_d = rays_at_pixels(pix, W, scene.K, scene.poses[img_i])
        target_c = scene.images[img_i].reshape(-1, 3)[pix]
        noise = None
        if mesh is not None:
            if perturb:
                dev = rays_o.device
                noise = (torch.rand((n_train, n_samples), generator=gen, device=dev),
                         torch.rand((n_train, n_importance), generator=gen, device=dev))
            rays_o, rays_d, target_c, noise = shard_batch((rays_o, rays_d, target_c, noise),
                                                         mesh)
            target_i = target_i[target_rows]
        return rays_o, rays_d, target_c, target_i, noise

    def update(state: TrainState, batch, gen: torch.Generator):
        """Loss, gradients and one Adam step on a batch from draw."""
        rays_o, rays_d, target_c, target_i, noise = batch
        total, metrics = loss_fn(state.params, rays_o, rays_d, target_c, target_i, gen, noise)
        # the gradients are cleared before backward (not after the update), so
        # they stay readable on the parameters after the step
        with span("train.backward"):
            state.opt.zero_grad(set_to_none=True)
            total.backward()
        with span("train.optimizer"):
            if mesh is not None:
                all_reduce_grads([p for g in state.opt.param_groups for p in g["params"]], mesh)
            state.opt.step()
            state.sched.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def step_fn(state: TrainState, scene: SceneArrays, gen: torch.Generator, img_i: int):
        with span("train.draw"):
            batch = draw(scene, gen, img_i)
        return update(state, batch, gen)

    step_fn.loss_fn = loss_fn
    step_fn.draw = draw
    step_fn.update = update
    return step_fn


def make_train_scan_step(args, cfg: FieldConfig, sampler: str = "full", mesh=None):
    """scan_fn(state, scene, base_seed, i_train, n_steps) -> metrics of the
    last of n_steps steps. Step s draws its image (uniform over i_train) and
    all its randomness from step_randomness(base_seed, s): training is a pure
    function of (init, base_seed, step). Each step is one `train.step` span
    around its five phases (utils/profiling.py)."""
    step_fn = make_train_step(args, cfg, sampler=sampler, mesh=mesh)

    def scan_fn(state: TrainState, scene: SceneArrays, base_seed: int,
                i_train: np.ndarray, n_steps: int):
        metrics = None
        for _ in range(n_steps):
            with span("train.step"):
                with span("train.draw"):
                    idx, gen = step_randomness(base_seed, state.step, len(i_train),
                                               scene.images.device)
                    batch = step_fn.draw(scene, gen, int(i_train[idx]))
                metrics = step_fn.update(state, batch, gen)
        return metrics

    return scan_fn
