"""dmnerf_torch — the PyTorch + CUDA (Hopper) port of dmnerf_tpu.

The layout mirrors dmnerf_tpu/ so each module's counterpart is found by path:

- core:     positional encoding, rays, depth sampling, alpha compositing.
- models:   the DM-NeRF field as an nn.Module, and the weight bridge to the
            JAX pytree and the reference DM-NeRF `.tar` checkpoint.
- kernels:  hand-written CUDA kernels for sm_90a (csrc/), their build, their
            ctypes bindings and their plain PyTorch versions.
- eval:     the chunked image renderer, PSNR/SSIM, instance AP and the
            render_test harness.
- cli:      `python -m dmnerf_torch.cli.test --config ... --render`.
- utils:    a stdlib PNG writer.

Host-side modules of dmnerf_tpu that import no jax are reused rather than
copied: dmnerf_tpu.config, dmnerf_tpu.data.base, dmnerf_tpu.data.synthetic and
dmnerf_tpu.utils.viz. Nothing here imports jax, orbax or imageio.
"""

__version__ = "0.1.0"
