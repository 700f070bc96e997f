"""The arithmetic of the f32 kernels' products on the CPU: field_core.cuh
multiplies fp32 operands in three TF32 passes on the tensor cores. Each
operand is split once, hi = tf32(x) and lo = tf32(x - hi) by cvt.rna (round
to nearest, ties away from zero, 10 mantissa bits), and each accumulator
takes lo_a hi_b, then hi_a lo_b, then hi_a hi_b per 8-deep reduction step
into a zeroed fragment that one fp32 add takes into the running sum. Here
that product is emulated bit for bit in the rounding and in the order of
the passes (the sums of each step in IEEE fp32, where the tensor cores
truncate), and every matmul of the port's plain f32 field
(models/fields.py) and of its plain K2 (kernels/field.py::field_backward_ref)
runs through it, K2's forward recompute included (on the card that one
sums in order of k on the CUDA cores, so that its ReLU masks are the plain
path's): at the flagship width the raw and the gradients stay within
F32_TOL / 10 of the plain fp32 path and of the JAX package's f32 field,
while one TF32 pass alone misses F32_TOL (the bar of the f32 kernels against
their plain versions on the card, tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.ops.pallas import render_field as jrf
from dmnerf_torch.kernels import field as kf
from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.kernels.render_field import pack_field
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import state_dict_from_jax

F32_TOL = 1e-4
# 8-deep steps per fp32 flush of the three passes' partial in the f32
# composites (csrc/composite_f32.cuh) and in field_core.cuh: every step
FLUSH = 1
# the flagship field (chip_smoke.py::FLAGSHIP) at K=32, 12 rays x 24 points
FLAGSHIP = dict(netdepth=8, netwidth=256, multires=10, multires_views=4, ins_num=32)
R, S = 12, 24


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bits of fp32 x: add half of the 13 dropped
    bits' place to the magnitude (a carry may reach the exponent), then clear
    them. The sign bit is untouched, so a tie rounds away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int = 3,
                 flush: int = 1) -> torch.Tensor:
    """a [..., K] @ b [K, N] as the kernels take it: per 8-deep step of the
    reduction, in order, a partial takes lo_a hi_b, hi_a lo_b and hi_a hi_b
    (passes 3), or hi_a hi_b alone (passes 1), and every flush steps the
    accumulator adds the partial and it starts from zero again, each sum in
    fp32."""
    lead, K = a.shape[:-1], a.shape[-1]
    a = a.reshape(-1, K)
    pad = -K % 8
    a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    steps = (K + pad) // 8

    def chunks(x, y):                    # the steps' partial products [steps, M, N]
        return torch.bmm(x.reshape(-1, steps, 8).transpose(0, 1), y.reshape(steps, 8, -1))

    terms = [chunks(al, bh), chunks(ah, bl), chunks(ah, bh)][3 - passes:]
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    for k in range(steps):
        for t in terms:
            part = part + t[k]
        if (k + 1) % flush == 0 or k + 1 == steps:
            acc, part = acc + part, torch.zeros_like(acc)
    return acc.reshape(*lead, b.shape[1])


class TF32Products(TorchFunctionMode):
    """Every fp32 matmul (`@`, torch.matmul) inside the block as the kernels'
    TF32 product."""

    def __init__(self, passes=3, flush=1):
        super().__init__()
        self.passes, self.flush = passes, flush

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__) and not kwargs:
            a, b = args
            if a.dtype == b.dtype == torch.float32 and b.dim() == 2:
                return tf32_product(a, b, self.passes, self.flush)
        return func(*args, **(kwargs or {}))


def numpy_params(cfg, seed):
    """The JAX package's field parameters (He-uniform, its layout) from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    W, X, V = cfg.netwidth, cfg.pos_ch, cfg.view_ch

    def lin(i, o):
        return {"w": (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / i)).astype(np.float32),
                "b": (rng.uniform(-1, 1, o) / np.sqrt(i)).astype(np.float32)}

    trunk, d = [], X
    for i in range(cfg.netdepth):
        trunk.append(lin(d, W))
        d = W + X if i == cfg.skip else W
    return {"trunk": trunk, "density": lin(W, 1), "rgb_feat": lin(W, W),
            "rgb_hidden": lin(W + V, W // 2), "rgb_out": lin(W // 2, 3),
            "ins_feat": lin(W, W), "ins_hidden": lin(W, W // 2),
            "ins_out": lin(W // 2, cfg.ins_num + 1)}


@pytest.fixture(scope="module")
def flagship():
    """The flagship f32 field in both packages, R x S points with one
    direction per ray, a cotangent g of raw, all from numpy seeds; the JAX
    package's raw and parameter gradients (jax.vjp of apply_field at g)."""
    cfg_j = jf.FieldConfig(**FLAGSHIP, compute_dtype=jnp.float32)
    params = numpy_params(cfg_j, 13)
    field = tf.DMNeRFField(tf.FieldConfig(**FLAGSHIP, compute_dtype=torch.float32))
    field.load_state_dict(state_dict_from_jax(params))
    rng = np.random.default_rng(13)
    rd = rng.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(1.0, 12.0, (R, S)), -1)
    pts = (rng.normal(size=(R, 1, 3)) * 0.3 + rd[:, None] * z[..., None]).astype(np.float32)
    vd = rd[:, None].astype(np.float32)
    g = (rng.normal(size=(R, S, FLAGSHIP["ins_num"] + 5)) * 1e-3).astype(np.float32)
    raw_j, vjp = jax.vjp(lambda p: jf.apply_field(p, cfg_j, jnp.asarray(pts), jnp.asarray(vd)),
                         jax.tree.map(jnp.asarray, params))
    (grads_j,) = vjp(jnp.asarray(g))
    grads_j = state_dict_from_jax(jax.tree.map(np.asarray, grads_j))
    return (field, torch.from_numpy(pts), torch.from_numpy(vd), torch.from_numpy(g),
            torch.from_numpy(np.array(raw_j)), [grads_j[n] for n, _ in field.named_parameters()])


def forward(field, pts, vd, passes=None):
    with torch.no_grad(), (TF32Products(passes) if passes else torch.no_grad()):
        return field(pts, vd)


def gradients(field, pts, vd, g, passes=None):
    """K2's plain version through the given products: one gradient per
    parameter of field."""
    packed = pack_field(field)
    pf, dirs, ppd = kf.flatten_inputs(pts, vd)
    with TF32Products(passes) if passes else torch.no_grad():
        got = kf.field_backward_ref(packed, pf, dirs, ppd, g.reshape(pf.shape[0], -1))
    return kf.unpack_grads(packed, got.dw, got.db)


def raw_error(got, want):
    """max |got - want| over max(1, max |want|), F32_TOL's measure."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def grad_error(got, want):
    """The worst relative L2 error over the parameters."""
    return max(float((a - b).norm() / b.norm()) for a, b in zip(got, want))


@pytest.mark.parametrize("bits,want", [
    (0x3F801000, 0x3F802000),     # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),     # its negative: away from zero too
    (0x3F800FFF, 0x3F800000),     # below the tie: down
    (0x3F801001, 0x3F802000),     # above it: up
    (0x3FFFF000, 0x40000000),     # the largest mantissa at a tie: carries into the exponent
    (0xC0490FDB, 0xC0490000),     # -pi: negative, down in magnitude
    (0x00000000, 0x00000000),     # zero
    (0x80000000, 0x80000000),     # negative zero
])
def test_rna_rounding_on_hand_picked_bits(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    assert rna_tf32(x).view(torch.int32).item() & 0xFFFFFFFF == want


def test_split_is_exact_to_fp32():
    """hi + lo holds x to 2^-21 of |x| (the dropped part of lo), each half
    has 13 clear low bits, and x - hi is exact in fp32."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)) \
        * torch.logspace(-20, 20, 4096)
    hi, lo = split_tf32(x)
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert torch.equal((x.double() - hi.double()).float(), x - hi)
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -21 * x.double().abs()).all()


def test_three_tf32_passes_hold_the_flagship_forward(flagship):
    """The raw of the 3-pass field within F32_TOL / 10 of the plain fp32
    field and of the JAX package's apply_field; one pass misses F32_TOL."""
    field, pts, vd, _, raw_j, _ = flagship
    plain, three, one = (forward(field, pts, vd, p) for p in (None, 3, 1))
    assert three.shape == plain.shape == raw_j.shape and torch.isfinite(three).all()
    assert raw_error(plain, raw_j) <= F32_TOL / 10
    assert raw_error(three, plain) <= F32_TOL / 10, raw_error(three, plain)
    assert raw_error(three, raw_j) <= F32_TOL / 10, raw_error(three, raw_j)
    assert raw_error(one, plain) > F32_TOL, raw_error(one, plain)


def test_three_tf32_passes_hold_the_flagship_gradients(flagship):
    """Every parameter's gradient from K2's plain version run on the 3-pass
    products within F32_TOL / 10 relative L2 of the plain fp32 run and of
    jax.vjp of apply_field; on one pass the worst parameter misses F32_TOL."""
    field, pts, vd, g, _, grads_j = flagship
    plain, three, one = (gradients(field, pts, vd, g, p) for p in (None, 3, 1))
    assert grad_error(plain, grads_j) <= F32_TOL / 10
    assert grad_error(three, plain) <= F32_TOL / 10, grad_error(three, plain)
    assert grad_error(three, grads_j) <= F32_TOL / 10, grad_error(three, grads_j)
    assert grad_error(one, plain) > F32_TOL, grad_error(one, plain)


@pytest.fixture(scope="module")
def flagship_composites():
    """The flagship f32 field in both packages, R x S points along rays from
    numpy seeds, and the JAX package's f32 render_field (the Pallas kernel
    in interpret mode) for heads "all" (rgb, depth, logits) and "ins"."""
    cfg_j = jf.FieldConfig(**FLAGSHIP, compute_dtype=jnp.float32)
    params = numpy_params(cfg_j, 15)
    field = tf.DMNeRFField(tf.FieldConfig(**FLAGSHIP, compute_dtype=torch.float32))
    field.load_state_dict(state_dict_from_jax(params))
    rng = np.random.default_rng(15)
    rd = rng.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(1.0, 12.0, (R, S)), -1)
    pts = rng.normal(size=(R, 1, 3)) * 0.3 + rd[:, None] * z[..., None]
    pts, z, rd, vd = (x.astype(np.float32) for x in (pts, z, rd, rd[:, None]))
    jx = [jnp.asarray(x) for x in (pts, vd, z, rd)]
    want = {"all": jrf.make_render_field(cfg_j, heads="all")(params, *jx),
            "ins": (jrf.make_render_field(cfg_j, heads="ins")(params, jx[0], *jx[2:]),)}
    want = {k: [torch.from_numpy(np.array(x)) for x in v] for k, v in want.items()}
    return field, [torch.from_numpy(x) for x in (pts, vd, z, rd)], want


@pytest.mark.parametrize("heads", ["all", "ins"])
def test_three_tf32_passes_hold_the_flagship_composites(flagship_composites, heads):
    """The plain K3 (heads "all": rgb, depth, logits) and K5 ("ins":
    logits) run on the 3-pass products with the f32 composites' flush
    interval (FLUSH) against the JAX package's f32 render_field and the
    plain fp32 path: each output within F32_TOL / 10 of max(1, its largest
    magnitude). The deviation from the JAX package is the order of fp32
    sums (its transmittance is an exp of a log-sum) and the split's
    rounding; one pass misses F32_TOL on the logits."""
    field, (pts, vd, z, rd), want = flagship_composites

    def run(passes=None):
        with torch.no_grad(), (TF32Products(passes, FLUSH) if passes else torch.no_grad()):
            if heads == "all":
                return krf.render_field_all_ref(field, pts, vd, z, rd)
            return (krf.render_field_ins_ref(field, pts, z, rd),)

    plain, three, one = run(), run(3), run(1)
    for name, p, t, j in zip(("rgb", "depth", "logits") if heads == "all" else ("logits",),
                             plain, three, want[heads]):
        assert t.shape == j.shape and torch.isfinite(t).all()
        assert raw_error(p, j) <= F32_TOL / 10, (name, raw_error(p, j))
        assert raw_error(t, p) <= F32_TOL / 10, (name, raw_error(t, p))
        assert raw_error(t, j) <= F32_TOL / 10, (name, raw_error(t, j))
    assert raw_error(one[-1], plain[-1]) > F32_TOL, raw_error(one[-1], plain[-1])
