"""mdhs_tpu_torch.ops.augment and ops.shear against the JAX package, on the CPU.

The shear is compared on the same per-row shifts ``d``; the crop, flip and
rotation on the same sampled values (the test re-draws the JAX sampler's own
values from its key and hands them to the port), so the two packages'
different random streams do not enter. On the CPU the port's
``shear_sublane`` takes its plain version; the CUDA kernel is held bit-exact
against that plain version in tests/test_torch_port_cuda.py.

Tolerances. XLA on the CPU contracts ``_shear_w``'s lerp
``(1 - f) * lo + f * hi`` into ``fma(1 - f, lo, f * hi)`` (one rounding
fewer), which the TPU and the port do not: the port's shear is held
bit-exact against that lerp evaluated with its three roundings, and within
one float32 ulp of the JAX function. A rotation computes tan(angle / 2) and
sin(angle) in float32, where torch and XLA may differ by an ulp; the shift
d = a * (r - center) reaches 30 pixels at 45 degrees and 64 pixels, so the
fraction f moves by up to ~4e-6, and an image in [0, 1] by as much: the
rotation and the crop / flip / rotate application are held within 1e-5 of
JAX (measured up to 4.1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.ops import augment as jaug
from mdhs_tpu_torch.ops import augment as taug
from mdhs_tpu_torch.ops import shear as tshear

torch.set_num_threads(2)

ROT_ATOL = 1e-5


def _shear_inputs(rng, C, H, W, pad):
    img = rng.random((C, H, W)).astype(np.float32)
    a = np.float32(rng.uniform(-1.0, 1.0) * (pad - 2) / (H / 2.0))  # |d| stays inside the pad
    return img, a


def _port_shear(img, d, pad):
    """JAX _shear_w's (C, H, W) image, W sheared by row H, in the port's layout:
    (1, C, W + 2 pad, H) with d (1, H)."""
    C, H, W = img.shape
    x = np.zeros((1, C, W + 2 * pad, H), np.float32)
    x[0, :, pad:pad + W, :] = img.transpose(0, 2, 1)
    out = tshear.shear_sublane(torch.from_numpy(x), torch.from_numpy(d[None].copy()), pad)
    return out.numpy()[0].transpose(0, 2, 1)


@pytest.mark.parametrize("pad, C, H, W", [(17, 3, 224, 224), (31, 3, 224, 224), (49, 2, 64, 61),
                                          (82, 2, 96, 53), (17, 3, 37, 224)])
def test_shear_matches_jax_shear_w(pad, C, H, W):
    rng = np.random.default_rng(pad + H)
    img, a = _shear_inputs(rng, C, H, W, pad)
    ref = np.asarray(jax.jit(jaug._shear_w, static_argnums=2)(jnp.asarray(img), jnp.float32(a), pad))
    d = np.asarray(jnp.float32(a) * (jnp.arange(H, dtype=jnp.float32) - (H - 1) / 2.0))  # _shear_w's d
    out = _port_shear(img, d, pad)
    assert out.shape == ref.shape == (C, H, W)
    # within one float32 ulp of XLA:CPU, which fuses the lerp into an FMA
    assert np.all(np.abs(out - ref) <= np.spacing(np.abs(ref).astype(np.float32)))
    # bit-exact against _shear_w's lerp with its three roundings
    d0 = np.floor(d)
    s = np.clip(pad + d0.astype(np.int64), 0, 2 * pad - 1)
    f = (d - d0).astype(np.float32)
    padded = np.pad(img, ((0, 0), (0, 0), (pad, pad)))
    cols = s[:, None] + np.arange(W)[None, :]
    lo = np.take_along_axis(padded, np.broadcast_to(cols, (C, H, W)), axis=2)
    hi = np.take_along_axis(padded, np.broadcast_to(cols + 1, (C, H, W)), axis=2)
    lerp = (np.float32(1.0) - f)[None, :, None] * lo + f[None, :, None] * hi
    np.testing.assert_array_equal(out, lerp)


def test_shear_gate():
    assert tshear.supports((32, 3, 258, 224), torch.float32, 17)
    assert tshear.supports((32, 3, 286, 224), torch.float32, 31)
    assert not tshear.supports((32, 3, 258, 224), torch.bfloat16, 17)
    assert not tshear.supports((32, 3, 34, 224), torch.float32, 17)  # nothing left after the pad
    assert not tshear.supports((32, 258, 224), torch.float32, 17)
    assert not tshear.supports((32, 3, 258, 224), torch.float32, 0)


def test_shear_pads_match_jax():
    # the static bounds rotate_3shear derives inline (mdhs_tpu/ops/augment.py:121-122)
    for deg, want in ((15.0, (17, 31)), (45.0, (49, 82))):
        assert taug.shear_pads(224, deg) == want
        assert want[0] == int(math.ceil(math.tan(math.radians(deg) / 2.0) * 224 / 2.0)) + 2


@pytest.mark.parametrize("degrees", [15.0, 45.0])
def test_rotate_3shear_matches_jax(degrees):
    rng = np.random.default_rng(int(degrees))
    imgs = rng.random((3, 64, 64, 3)).astype(np.float32)
    angles = np.radians(rng.uniform(-degrees, degrees, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jaug.rotate_3shear, static_argnums=2)(jnp.asarray(imgs), jnp.asarray(angles),
                                                                   degrees))
    out = taug.rotate_3shear(torch.from_numpy(imgs), torch.from_numpy(angles), degrees).numpy()
    assert out.shape == ref.shape == imgs.shape
    np.testing.assert_allclose(out, ref, atol=ROT_ATOL, rtol=0)


def test_tent_matrix_matches_jax():
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.uniform(-2.0, 40.0, 50), [0.0, 31.0, 31.5, 32.0, -0.5]]).astype(np.float32)
    ref = np.asarray(jaug._tent_matrix(jnp.asarray(pos), 32))
    out = taug._tent_matrix(torch.from_numpy(pos), 32).numpy()
    np.testing.assert_array_equal(out, ref)
    batched = taug._tent_matrix(torch.from_numpy(pos.reshape(5, 11)), 32).numpy()
    np.testing.assert_array_equal(batched.reshape(55, 32), ref)


def _jax_sampled_values(key, B, S, *, vflip, degrees, scale_range=(0.2, 1.0), ratio_range=(3 / 4, 4 / 3)):
    """The values mdhs_tpu/ops/augment.py::random_crop_flip_rotate draws from
    ``key`` (its ``params``, :178-191), re-drawn with the same key splits."""
    out = []
    for k in jax.random.split(key, B):
        k_area, k_ratio, k_hf, k_vf, k_ang, k_x, k_y = jax.random.split(k, 7)
        area = S * S * jax.random.uniform(k_area, (), minval=scale_range[0], maxval=scale_range[1])
        log_r = jax.random.uniform(k_ratio, (), minval=math.log(ratio_range[0]), maxval=math.log(ratio_range[1]))
        ratio = jnp.exp(log_r)
        w = jnp.clip(jnp.sqrt(area * ratio), 8.0, S)
        h = jnp.clip(jnp.sqrt(area / ratio), 8.0, S)
        y0 = jax.random.uniform(k_y, ()) * (S - h)
        x0 = jax.random.uniform(k_x, ()) * (S - w)
        do_h = jax.random.bernoulli(k_hf) & True
        do_v = jax.random.bernoulli(k_vf) & vflip
        ang = jax.random.uniform(k_ang, (), minval=-degrees, maxval=degrees) * math.pi / 180.0
        out.append([float(y0), float(x0), float(h), float(w), bool(do_h), bool(do_v), float(ang)])
    cols = list(zip(*out))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return taug.CropFlipRotate(f32(cols[0]), f32(cols[1]), f32(cols[2]), f32(cols[3]),
                               torch.tensor(cols[4]), torch.tensor(cols[5]), f32(cols[6]))


@pytest.mark.parametrize("vflip, degrees", [(False, 15.0), (True, 45.0), (False, 0.0)])
def test_crop_flip_rotate_application_matches_jax(vflip, degrees):
    B, S, O = 4, 72, 64
    key = jax.random.PRNGKey(int(degrees) + 7 * vflip)
    imgs = np.random.default_rng(5).random((B, S, S, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jaug.random_crop_flip_rotate, static_argnums=2,
                             static_argnames=("vflip", "degrees"))(key, jnp.asarray(imgs), O, vflip=vflip,
                                                                   degrees=degrees))
    p = _jax_sampled_values(key, B, S, vflip=vflip, degrees=degrees)
    out = taug.apply_crop_flip_rotate(torch.from_numpy(imgs), p, O, degrees).numpy()
    assert out.shape == ref.shape == (B, O, O, 3)
    np.testing.assert_allclose(out, ref, atol=ROT_ATOL, rtol=0)


def test_train_pipeline_is_the_model_input():
    B, S, O = 3, 72, 64
    rng = np.random.default_rng(6)
    canvas = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8))
    p = taug.sample_crop_flip_rotate(B, S, torch.Generator().manual_seed(0), vflip=False, degrees=15.0)
    x = taug.train_pipeline(canvas, torch.Generator(), O, dtype=torch.float32, params=p)
    assert x.shape == (B, 3, O, O) and x.is_contiguous(memory_format=torch.channels_last)
    want = taug.apply_crop_flip_rotate(canvas.float() / 255.0, p, O, 15.0).permute(0, 3, 1, 2)
    torch.testing.assert_close(x, want, atol=0, rtol=0)


def test_sampler_ranges():
    B, S, deg = 4096, 256, 15.0
    g = torch.Generator().manual_seed(1)
    p = taug.sample_crop_flip_rotate(B, S, g, vflip=False, degrees=deg)
    assert all(t.shape == (B,) for t in p)
    assert float(p.angle.abs().max()) <= math.radians(deg) and float(p.angle.abs().max()) > 0.9 * math.radians(deg)
    assert not bool(p.vflip.any())                            # MIBF: no vflip
    assert 0.45 < float(p.hflip.float().mean()) < 0.55
    assert bool(((p.h >= 8) & (p.h <= S) & (p.w >= 8) & (p.w <= S)).all())
    assert bool(((p.y0 >= 0) & (p.y0 + p.h <= S + 1e-3) & (p.x0 >= 0) & (p.x0 + p.w <= S + 1e-3)).all())
    area = p.h * p.w / (S * S)  # clipping only trims: the area fraction stays within the scale range
    assert float(area.min()) >= 0.2 * (3 / 4) - 1e-6 and float(area.max()) <= 1.0 + 1e-6
    both = taug.sample_crop_flip_rotate(B, S, torch.Generator().manual_seed(2), vflip=True, degrees=45.0)
    assert 0.45 < float(both.vflip.float().mean()) < 0.55
    assert float(both.angle.abs().max()) <= math.radians(45.0)
