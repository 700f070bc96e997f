"""dmnerf_torch — the PyTorch + CUDA (Hopper) port of dmnerf_tpu.

The layout mirrors dmnerf_tpu/ so each module's counterpart is found by path:

- core:     positional encoding, rays, depth sampling, alpha compositing.
- models:   the DM-NeRF field as an nn.Module, and the weight bridge to the
            JAX pytree and the reference DM-NeRF `.tar` checkpoint.
- kernels:  hand-written CUDA kernels for sm_90a (csrc/), their build, their
            ctypes bindings and their plain PyTorch versions.
- eval:     the chunked image renderer, PSNR/SSIM, LPIPS (VGG16 on cuDNN),
            instance AP and the render_test harness.
- parallel: the ray mesh on torch.distributed: one process per card, rays
            split over them, loss statistics and gradients summed.
- cli:      `python -m dmnerf_torch.cli.train` and `dmnerf_torch.cli.test`,
            under torchrun on several cards.
- config, data, edit/transforms, edit/deform, utils/viz: copies of the JAX
            package's host modules (numpy only), each naming its source on
            its first line; the DM-SR, Replica and ScanNet readers and the
            stress scenes (data/procedural.py) are ported instead.
- utils:    also a PNG reader and writer and an HDF5 reader and writer on
            the standard library and numpy, a baseline JPEG codec
            (native/jpeg.cpp, built by g++) equal to libjpeg-turbo's, and
            the torch.profiler trace of --profile_steps.
- tools:    the stress scenes in the reference formats and their drill
            through the CLIs, the train step's trace and its reader, the
            LPIPS weight converter and the readers of a run's records.

The port imports nothing of dmnerf_tpu, not even a module there that imports
no jax: what it needs of such a module is copied here. Nothing here imports
jax, orbax, imageio, h5py, cv2 or PIL.
"""

__version__ = "0.1.0"
