"""The plain torch versions of the port's three CUDA kernels against the
JAX package, and the wrappers' dispatch.

K1 (``ops/fast.py::fast_nms_reference``) is exact against the reference's
main-path XLA formulation ``fast.fast_score`` + ``image.maxpool3x3`` and, as
``tests/test_pallas_fast.py`` holds the Pallas kernel, within 1e-5 of
``pallas_fast.fast_score_nms(interpret=True)`` away from the 1-px border
(the Pallas kernel edge-pads the score map where the XLA path pads -inf).
K2 (``ops/matching.py::hamming_nn_reference``) is exact against
``matching.nearest_keypoints_packed`` (the C-minor packed pool, the JAX
package's CPU path ``_hamming_packed_xla_T``) and ``matching.nearest_keypoints``
(the bipolar pool).  K3 (``ops/matching.py::hamming_matrix_reference``) is
exact against ``pallas_match.hamming_matrix_packed`` (its XLA path on the
CPU) and against the Pallas ``_kernel`` itself, run in interpret mode with
the BlockSpecs of ``_hamming_packed_pallas`` and the ``_TILE_PERM``-permuted
keypoints.  The kernels themselves run only on a CUDA device
(tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import asnp, small_scene, t
from rgbd_visualodometry_tpu.ops import fast as jfast
from rgbd_visualodometry_tpu.ops import image as jim
from rgbd_visualodometry_tpu.ops import matching as jmatch
from rgbd_visualodometry_tpu.ops import pallas_fast, pallas_match
from rgbd_visualodometry_tpu.ops.pallas_match import unpack_bipolar
from rgbd_visualodometry_tpu_torch import kernels
from rgbd_visualodometry_tpu_torch.ops import fast as tfast
from rgbd_visualodometry_tpu_torch.ops import matching as tmatch


def _blocks(shape, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.float32)
    for _ in range(25):
        y, x = rng.integers(5, shape[0] - 10), rng.integers(5, shape[1] - 10)
        h, w = rng.integers(5, 20, 2)
        img[y : y + h, x : x + w] += rng.uniform(30, 120)
    return np.clip(img + rng.normal(0, 2, shape), 0, 255).astype(np.float32)


def _jax_nms(img):
    def f(g):
        s = jfast.fast_score(g)
        return jnp.where(s >= jim.maxpool3x3(s), s, 0.0)

    return np.asarray(jax.jit(f)(jnp.asarray(img)))


def _frame():
    f = small_scene().render(np.array([1.0, 0, 0, 0, 0.02, 0.0, 0.0]), 0.0)
    return np.asarray(jax.jit(jim.rgb_to_gray)(jnp.asarray(f.rgb)))


@pytest.mark.parametrize("shape", [(120, 160), (64, 128), (97, 203), (9, 9)])
def test_fast_nms_reference_exact_vs_xla_path(shape):
    img = _blocks(shape, sum(shape)) if min(shape) > 30 else np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    np.testing.assert_array_equal(asnp(tfast.fast_nms_reference(t(img))), _jax_nms(img))


def test_fast_nms_reference_exact_on_a_frame():
    img = _frame()
    got = asnp(tfast.fast_nms_reference(t(img)))
    np.testing.assert_array_equal(got, _jax_nms(img))
    assert (got > 20).sum() > 300


@pytest.mark.parametrize("shape", [(120, 160), (64, 128)])
def test_fast_nms_reference_vs_pallas_interpret(shape):
    img = _blocks(shape, 1)
    want = np.asarray(pallas_fast.fast_score_nms(jnp.asarray(img), interpret=True))
    got = asnp(tfast.fast_nms_reference(t(img)))
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1], atol=1e-5)


def _descriptors(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _nn_cases():
    rng = np.random.default_rng(5)
    cand, kp = _descriptors(rng, 1500), _descriptors(rng, 300)
    mask = rng.random(300) >= 0.1
    tie_kp = np.concatenate([kp[:150], kp[:150]])  # every distance tied twice
    tie_cand = cand.copy()
    tie_cand[:300] = kp[rng.integers(0, 300, 300)]  # exact hits, distance 0
    near = kp[rng.integers(0, 300, 1500)] ^ (rng.random((1500, 8)) < 0.01).astype(np.uint32)  # near matches
    return {
        "random": (cand, kp, mask),
        "ties": (tie_cand, tie_kp, mask),
        "near": (near, kp, mask),
        "ragged": (cand[:1023], kp, mask),
        "all_masked": (cand[:100], kp, np.zeros(300, bool)),
    }


@pytest.mark.parametrize("case", ["random", "ties", "near", "ragged", "all_masked"])
def test_hamming_nn_reference_exact(case):
    cand, kp, mask = _nn_cases()[case]
    got = tmatch.hamming_nn_reference(t(cand.view(np.int32)), t(kp.view(np.int32)), t(mask))
    kp_bip = unpack_bipolar(jnp.asarray(kp))
    packed = jmatch.nearest_keypoints_packed(jnp.asarray(cand.T), kp_bip, jnp.asarray(mask))
    dense = jmatch.nearest_keypoints(unpack_bipolar(jnp.asarray(cand)), kp_bip, jnp.asarray(mask))
    for want in (packed, dense):
        np.testing.assert_array_equal(asnp(got.kp_index), np.asarray(want.kp_index))
        np.testing.assert_array_equal(asnp(got.distance), np.asarray(want.distance))
    assert got.kp_index.dtype == torch.int32 and got.distance.dtype == torch.int32
    if case == "all_masked":
        assert (asnp(got.distance) == tmatch.BIG).all() and (asnp(got.kp_index) == 0).all()


def _pallas_kernel_interpret(cand, kp_bip, tile):
    """``pallas_match._kernel`` through ``pl.pallas_call(interpret=True)``,
    laid out as ``_hamming_packed_pallas`` lays it out (pallas_match.py:98-113)."""
    from jax.experimental import pallas as pl

    C, N = cand.shape[0], kp_bip.shape[0]
    kp_perm = jnp.take(kp_bip, jnp.asarray(pallas_match._TILE_PERM), axis=1)
    return pl.pallas_call(
        pallas_match._kernel,
        out_shape=jax.ShapeDtypeStruct((C, N), jnp.int32),
        grid=(C // tile,),
        in_specs=[
            pl.BlockSpec((tile, pallas_match.WORDS), lambda i: (i, 0)),
            pl.BlockSpec((N, pallas_match.BITS), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((tile, N), lambda i: (i, 0)),
        interpret=True,
    )(cand, kp_perm)


@pytest.mark.parametrize("case", ["random", "ties", "near", "ragged", "empty"])
def test_hamming_matrix_reference_exact(case):
    if case == "empty":
        cand, kp = np.zeros((0, 8), np.uint32), _nn_cases()["random"][1]
    else:
        cand, kp, _ = _nn_cases()[case]
    got = asnp(tmatch.hamming_matrix_reference(t(cand.view(np.int32)), t(kp.view(np.int32))))
    want = np.asarray(pallas_match.hamming_matrix_packed(jnp.asarray(cand), unpack_bipolar(jnp.asarray(kp))))
    assert got.dtype == np.int32 and got.shape == (cand.shape[0], kp.shape[0])
    np.testing.assert_array_equal(got, want)


def test_hamming_matrix_reference_exact_vs_pallas_interpret():
    rng = np.random.default_rng(11)
    cand, kp = _descriptors(rng, 2048), _descriptors(rng, 40)
    cand[:40] = kp  # distance 0 on the diagonal
    want = np.asarray(_pallas_kernel_interpret(jnp.asarray(cand), unpack_bipolar(jnp.asarray(kp)), tile=1024))
    got = asnp(tmatch.hamming_matrix_reference(t(cand.view(np.int32)), t(kp.view(np.int32))))
    np.testing.assert_array_equal(got, want)
    assert (np.diag(got[:40]) == 0).all()


def test_wrappers_take_the_plain_version_on_cpu():
    kernels.reset_counts()
    img = t(_blocks((64, 96), 2))
    assert torch.equal(tfast.fast_nms(img), tfast.fast_nms_reference(img))
    cand, kp, mask = _nn_cases()["random"]
    a = tmatch.nearest_keypoints_packed(t(cand.view(np.int32)), t(kp.view(np.int32)), t(mask))
    b = tmatch.hamming_nn_reference(t(cand.view(np.int32)), t(kp.view(np.int32)), t(mask))
    assert torch.equal(a.kp_index, b.kp_index) and torch.equal(a.distance, b.distance)
    m = tmatch.hamming_matrix_packed(t(cand.view(np.int32)), t(kp.view(np.int32)))
    assert torch.equal(m, tmatch.hamming_matrix_reference(t(cand.view(np.int32)), t(kp.view(np.int32))))
    assert kernels.counts() == {"fast_nms": 0, "hamming_nn": 0, "hamming_matrix": 0}


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        tfast.fast_nms(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        tfast.fast_nms(torch.zeros(2, 8, 8))
    with pytest.raises(ValueError):
        tfast.fast_nms(torch.zeros(8, 8, device="meta"))
    d = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmatch.nearest_keypoints_packed(d, d, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        tmatch.nearest_keypoints_packed(d.long(), d, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        tmatch.nearest_keypoints_packed(d.to("meta"), d.to("meta"), torch.ones(4, dtype=torch.bool, device="meta"))
    for bad in ((d[:, :7], d), (d, d.long()), (d.to("meta"), d.to("meta")), (d, d.to("meta"))):
        with pytest.raises(ValueError):
            tmatch.hamming_matrix_packed(*bad)


def test_kernel_library_is_named_by_its_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("librgbdvo_kernels_")
    assert {p.name for p in kernels.CSRC.glob("*.cu")} == {"fast_nms.cu", "hamming_nn.cu"}
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for k in kernels.KERNELS:
        assert (kernels._PKG.parent / k.source).exists()
