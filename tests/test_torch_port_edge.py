"""The port's edge toolbox and TPU kernels 5 and 6 on the CPU, against the
JAX package on the same numpy inputs.

- Kernel 5's plain twin (``ops/edge_cuda.fused_canny_reference``) against
  JAX ``fused_canny_auto`` (the Pallas kernel in interpret mode) and the XLA
  ``canny_edge``, with the JAX package's own policy
  (``tests/test_pallas_canny.py``): exact on random inputs, at most 1% of
  pixels on tie-heavy disks, whose blurred edges sit on exact >= ties that
  separable-vs-dense blur and mag-vs-mag^2 comparisons flip.
- Its ``improve`` mode against JAX ``non_max_suppression`` of the reflect-
  padded, eps-stabilised gradients within atol 1e-5 (measured: 5e-7).
- ``ops/edge.py`` and ``ops/enhance.py`` within 1e-5 of JAX (float32
  convolutions summed in another order), binary outputs exactly.
- Kernel 6's twin (``ops/conv_cuda.conv3x3_reference``) against JAX
  ``conv3x3_pallas(..., interpret=True)`` with ``tests/test_conv_pallas.py``'s
  tolerances.
- The hysteresis kernel's algorithm (rounds over 32x32 tiles, each grown to
  a local fixpoint from a 1-pixel halo), emulated, exactly against JAX
  ``hysteresis_thresholding``; kernel 5's tap cache.

The CUDA kernels themselves run in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.ops import edge as jedge
from eelunet_tpu.ops import enhance as jenh
from eelunet_tpu.ops.conv_pallas import conv3x3_pallas
from eelunet_tpu.ops.edge_pallas import _g5, fused_canny_auto
from eelunet_tpu_torch.ops import conv_cuda, edge, edge_cuda, enhance
from torch_port_helpers import hysteresis_tiled_emulated, serpentine


def _disk(h, w, cy, cx, r):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.asarray(a)


# Random fields: binary masks and smooth [0,1] noise, H and W not multiples of 8.
RANDOM = {
    "binary": lambda rng: (rng.uniform(size=(2, 45, 38, 1)) > 0.6).astype(np.float32),
    "uniform": lambda rng: rng.uniform(size=(2, 37, 45, 1)).astype(np.float32),
    "noisy_disk": lambda rng: (_disk(70, 41, 35, 20, 20)
                               + rng.uniform(0, 1e-3, (70, 41)).astype(np.float32)
                               )[None, :, :, None],
}


@pytest.mark.parametrize("tile_h", [32, 96])
@pytest.mark.parametrize("field", sorted(RANDOM))
def test_kernel5_twin_zero_exact_on_random(field, tile_h):
    x = RANDOM[field](np.random.default_rng(1))
    got = edge_cuda.fused_canny_reference(_t(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape and got.sum() > 0
    np.testing.assert_array_equal(got, _j(fused_canny_auto(jnp.asarray(x), tile_h=tile_h)))
    np.testing.assert_array_equal(got, _j(jedge.canny_edge(jnp.asarray(x))))


@pytest.mark.parametrize("tile_h", [32, 96])
def test_kernel5_twin_zero_on_disks(tile_h):
    x = np.stack([_disk(64, 72, 32, 36, 18), _disk(64, 72, 20, 50, 11)])[..., None]
    got = edge_cuda.fused_canny_reference(_t(x)).numpy()
    assert got.sum() > 0
    for want in (fused_canny_auto(jnp.asarray(x), tile_h=tile_h), jedge.canny_edge(jnp.asarray(x))):
        assert (got != _j(want)).mean() <= 0.01


def _jax_improve_nms(x):
    blur = jedge.gaussian_blur(jnp.asarray(x))
    return _j(jedge.non_max_suppression(*jedge._grad_mag_angle(blur, reflect_pad=True,
                                                               angle_eps=1e-6)))


@pytest.mark.parametrize("field", ["binary", "uniform"])
def test_kernel5_twin_improve_matches_jax_nms(field):
    x = RANDOM[field](np.random.default_rng(2))
    got = edge_cuda.fused_canny_reference(_t(x), mode="improve").numpy()
    want = _jax_improve_nms(x)
    assert (got > 0).sum() > 0
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The CPU chain of ops/edge.py (dense convolutions) as well.
    np.testing.assert_allclose(edge._improve_nms(_t(x), 5, 1.0).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("field", ["disk", "noisy_disk"])
def test_kernel5_twin_improve_on_disks(field):
    """Near-ties: 1e-3 of noise does not break every tie of the improved
    chain, whose NMS compares mag, not mag^2 (1 pixel in 2870 flips here)."""
    x = (_disk(64, 64, 32, 32, 18)[None, :, :, None] if field == "disk"
         else RANDOM[field](np.random.default_rng(2)))
    got = edge_cuda.fused_canny_reference(_t(x), mode="improve").numpy()
    want = _jax_improve_nms(x)
    assert ((got > 0) != (want > 0)).mean() <= 0.01
    both = (got > 0) & (want > 0)
    np.testing.assert_allclose(got[both], want[both], atol=1e-5, rtol=0)


def test_fused_canny_wrapper_runs_the_twin_on_the_cpu():
    x = RANDOM["uniform"](np.random.default_rng(3))
    edge_cuda.reset_launches()
    for mode in ("zero", "improve"):
        got = edge_cuda.fused_canny(_t(x), 0.3, 0.8, 1.2, mode=mode)
        want = edge_cuda.fused_canny_reference(_t(x), 0.3, 0.8, 1.2, mode=mode)
        assert torch.equal(got, want)
    assert edge_cuda.LAUNCHES == {"fused_canny": 0, "hysteresis": 0}
    np.testing.assert_array_equal(
        edge_cuda.fused_canny(_t(x), 0.3, sigma=1.2).numpy(),
        _j(fused_canny_auto(jnp.asarray(x), low_threshold=0.3, gaussian_sigma=1.2)))
    with pytest.raises(ValueError, match="mode"):
        edge_cuda.fused_canny(_t(x), mode="reflect")
    with pytest.raises(ValueError, match="N,H,W,1"):
        edge_cuda.fused_canny(_t(np.zeros((1, 8, 8, 3), np.float32)))


# ---------------------------------------------------------------- ops/edge.py

def test_grayscale_and_gaussian_kernel():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(edge.rgb_to_grayscale(_t(x)).numpy(),
                               _j(jedge.rgb_to_grayscale(jnp.asarray(x))), rtol=0, atol=1e-7)
    for size, sigma in ((5, 1.0), (3, 0.7), (7, 2.0)):
        np.testing.assert_array_equal(edge.gaussian_kernel(size, sigma),
                                      jedge.gaussian_kernel(size, sigma))


@pytest.mark.parametrize("channels", [1, 3])
def test_blur_sobel_nms_match_jax(channels):
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 29, 34, channels)).astype(np.float32)
    blur_t, blur_j = edge.gaussian_blur(_t(x)), jedge.gaussian_blur(jnp.asarray(x))
    np.testing.assert_allclose(blur_t.numpy(), _j(blur_j), atol=1e-5, rtol=0)
    for reflect in (False, True):
        for gt, gj in zip(edge.sobel_gradients(_t(x), reflect_pad=reflect),
                          jedge.sobel_gradients(jnp.asarray(x), reflect_pad=reflect)):
            np.testing.assert_allclose(gt.numpy(), _j(gj), atol=1e-5, rtol=0)
    mag = rng.uniform(size=x.shape).astype(np.float32)
    ang = rng.uniform(-200, 400, size=x.shape).astype(np.float32)
    np.testing.assert_array_equal(edge.non_max_suppression(_t(mag), _t(ang)).numpy(),
                                  _j(jedge.non_max_suppression(jnp.asarray(mag),
                                                               jnp.asarray(ang))))


@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_hysteresis_matches_jax_exactly(max_iters):
    rng = np.random.default_rng(6)
    strong = (rng.uniform(size=(2, 40, 33, 1)) > 0.97).astype(np.float32)
    weak = (rng.uniform(size=(2, 40, 33, 1)) > 0.45).astype(np.float32)
    got = edge.hysteresis_thresholding(_t(strong), _t(weak), max_iters).numpy()
    want = _j(jedge.hysteresis_thresholding(jnp.asarray(strong), jnp.asarray(weak), max_iters))
    np.testing.assert_array_equal(got, want)
    grown, steps = edge.hysteresis_fixpoint(_t(strong) > 0.5, _t(weak) > 0.5, max_iters)
    assert steps == max_iters if max_iters else steps > 3
    if max_iters == 0:  # at the fixpoint one more step changes nothing
        assert torch.equal(grown, grown | (edge._dilate(grown) & (_t(weak) > 0.5)))


def _levels(strong, weak):
    """An NMS-like map from bool maps: 1.0 strong, 0.5 weak, 0 off, to be
    thresholded at low 0.25, high 0.75."""
    return np.where(strong, 1.0, np.where(weak, 0.5, 0.0)).astype(np.float32)


def _hysteresis_maps():
    rng = np.random.default_rng(11)
    u = rng.uniform(size=(2, 70, 100, 1))
    return {
        # strong seeds in weak clusters that cross tile edges
        "random": _levels(u > 0.97, u > 0.45),
        "serpentine": serpentine(64, 160),
        "no_strong": _levels(u > 2.0, u > 0.3),
        "all_weak": _levels(np.zeros_like(u, bool), np.ones_like(u, bool)),
        "all_weak_one_strong": _levels(np.pad(np.ones((2, 1, 1, 1), bool),
                                              ((0, 0), (0, 69), (0, 99), (0, 0))),
                                       np.ones_like(u, bool)),
    }


@pytest.mark.parametrize("schedule", ["snapshot", "in_order"])
@pytest.mark.parametrize("name", ["random", "serpentine", "no_strong", "all_weak",
                                  "all_weak_one_strong"])
def test_hysteresis_tiles_match_jax_exactly(name, schedule):
    """The hysteresis kernel's rounds over 32x32 tiles reach exactly the
    fixpoint JAX's while_loop reaches, whichever order the tiles are
    relaxed in; the serpentine path needs many rounds, each crossing one
    tile boundary at least."""
    m = _hysteresis_maps()[name]
    got, rounds = hysteresis_tiled_emulated(_t(m), 0.25, 0.75, schedule)
    want = _j(jedge.hysteresis_thresholding(jnp.asarray(m >= 0.75, jnp.float32),
                                            jnp.asarray((m >= 0.25) & (m < 0.75), jnp.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    plain, steps = edge_cuda.hysteresis(_t(m), 0.25, 0.75)  # the CPU wrapper: the plain loop
    np.testing.assert_array_equal(plain.numpy(), want)
    print(f"{name} {schedule}: {rounds} rounds, plain loop {int(steps)} steps, "
          f"{want.mean():.4f} on")
    if name == "serpentine":
        assert want.sum() == (m > 0).sum() and rounds > 10 and int(steps) > 1000
    if name in ("no_strong", "all_weak"):
        assert want.sum() == 0 and rounds == 1
    if name == "all_weak_one_strong":
        assert want.all()


def test_hysteresis_wrapper_on_the_cpu_and_the_thresholding_entry():
    """On a CPU tensor ``hysteresis`` runs the plain loop (no launch) and
    returns its step count; ``hysteresis_thresholding`` and
    ``canny_edge_improve`` keep JAX's exact results there."""
    m = _hysteresis_maps()["random"]
    edge_cuda.reset_launches()
    got, steps = edge_cuda.hysteresis(_t(m), 0.25, 0.75, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == m.shape and int(steps) > 3
    assert edge_cuda.LAUNCHES == {"fused_canny": 0, "hysteresis": 0}
    assert torch.equal(got.float(), edge_cuda.hysteresis_reference(_t(m), 0.25, 0.75))
    strong, weak = (m >= 0.75).astype(np.float32), ((m >= 0.25) & (m < 0.75)).astype(np.float32)
    np.testing.assert_array_equal(edge.hysteresis_thresholding(_t(strong), _t(weak)).numpy(),
                                  got.float().numpy())
    with pytest.raises(ValueError, match="N,H,W,1"):
        edge_cuda.hysteresis(_t(m[..., 0]), 0.25, 0.75)


def test_kernel5_tap_cache():
    """The wrapper computes the Gaussian taps once per sigma: the cached
    taps are JAX's ``_g5`` exactly, and the twin gives the same output
    from a cold and a warm cache."""
    x = _t(RANDOM["uniform"](np.random.default_rng(12)))
    edge_cuda.taps.cache_clear()
    cold = edge_cuda.fused_canny_reference(x, sigma=1.3, mode="improve")
    assert edge_cuda.taps.cache_info().misses == 1
    warm = edge_cuda.fused_canny_reference(x, sigma=1.3, mode="improve")
    assert edge_cuda.taps.cache_info().hits >= 1 and torch.equal(cold, warm)
    for sigma in (1.0, 1.3):
        assert edge_cuda.taps(sigma) == tuple(float(v) for v in _g5(sigma))
        assert edge_cuda.taps(sigma) == tuple(float(v) for v in edge_cuda.g5(sigma))


@pytest.mark.parametrize("field", sorted(RANDOM))
def test_canny_chains_match_jax_exactly(field):
    x = RANDOM[field](np.random.default_rng(7))
    np.testing.assert_array_equal(edge.canny_edge(_t(x), 0.3).numpy(),
                                  _j(jedge.canny_edge(jnp.asarray(x), 0.3)))
    got = edge.canny_edge_improve(_t(x), 100 / 255, 200 / 255).numpy()
    assert got.sum() > 0
    np.testing.assert_array_equal(
        got, _j(jedge.canny_edge_improve(jnp.asarray(x), 100 / 255, 200 / 255)))
    np.testing.assert_array_equal(edge.generate_edge_label(_t(x)).numpy(),
                                  _j(jedge.generate_edge_label(jnp.asarray(x))))


# ------------------------------------------------------------- ops/enhance.py

def _images(seed=8, shape=(2, 36, 44, 3)):
    """Soft blobs in [0,1] with noise: edges strong enough for every
    threshold the enhancers use."""
    rng = np.random.default_rng(seed)
    b, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy - h / 2) ** 2 / (h / 4) ** 2 + (xx - w / 3) ** 2 / (w / 5) ** 2 < 1.0)
    img = 0.3 + 0.5 * base[None, :, :, None] * rng.uniform(0.6, 1.0, (b, 1, 1, 3))
    return np.clip(img + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("name", ["edge_brighten", "per_channel_canny_enhance",
                                  "sobel_magnitude", "laplacian", "hsv_value_canny",
                                  "hsv_hue_sobel", "rgb_to_hsv_value"])
def test_enhance_matches_jax(name):
    x = _images()
    got = getattr(enhance, name)(_t(x)).numpy()
    want = _j(getattr(jenh, name)(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "hsv_value_canny":
        assert got.sum() > 0
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if name in ("edge_brighten", "per_channel_canny_enhance"):
        assert not np.array_equal(got, x)  # the edges changed the image


@pytest.mark.parametrize("k", [3, 10])
def test_morph_close_matches_jax(k):
    x = (np.random.default_rng(9).uniform(size=(2, 23, 30, 1)) > 0.8).astype(np.float32)
    np.testing.assert_array_equal(enhance._morph_close(_t(x), k).numpy(),
                                  _j(jenh._morph_close(jnp.asarray(x), k)))


# ------------------------------------------------------------------ kernel 6

@pytest.mark.parametrize("cin,cout,affine,relu", [
    (3, 32, True, False),     # enc1: RGB in
    (64, 64, True, True),     # the full-resolution decoder shapes, scaled down
    (128, 64, False, True),
    (64, 16, False, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel6_twin_matches_jax_conv3x3_pallas(cin, cout, affine, relu, dtype):
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, 16, 24, cin), dtype=np.float32)
    w = (rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.1)
    scale = rng.standard_normal(cout, dtype=np.float32) if affine else None
    shift = rng.standard_normal(cout, dtype=np.float32) if affine else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    want = conv3x3_pallas(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                          None if scale is None else jnp.asarray(scale),
                          None if shift is None else jnp.asarray(shift),
                          relu=relu, tile_h=8, interpret=True)
    conv_cuda.reset_launches()
    got = conv_cuda.conv3x3(_t(x).to(tdt), _t(w).to(tdt),
                            None if scale is None else _t(scale),
                            None if shift is None else _t(shift), relu=relu)
    assert conv_cuda.LAUNCHES == {"conv3x3": 0}
    assert got.dtype == tdt and tuple(got.shape) == (2, 16, 24, cout)
    tol = 2e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_kernel6_wrapper_rejects_bad_weights():
    x = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError, match="3,3,Cin,Cout"):
        conv_cuda.conv3x3(x, torch.zeros((3, 3, 5, 8)))
