"""The port's CUDA kernels against their plain torch versions, on a card.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these skip without a
device.  The file imports neither jax nor the JAX package, so it also runs
on a machine without jax:

    python3 -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

Tolerance: none - K1 uses only subtraction, min and max, K2 and K3 only
integers.
"""

import numpy as np
import pytest
import torch

from rgbd_visualodometry_tpu_torch import _shared, kernels
from rgbd_visualodometry_tpu_torch.ops import fast, image as im, matching


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain K2 matmul stays exact
    return torch.device("cuda")


def _images():
    sc = _shared.SyntheticScene(width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6)
    gray = im.rgb_to_gray(torch.from_numpy(sc.render(np.array([1.0, 0, 0, 0, 0.02, 0, 0])).rgb))
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.uniform(0, 255, (97, 203)).astype(np.float32))
    flat = torch.full((33, 47), 7.0)
    return [*im.build_pyramid(gray, 4, 1.2), noise, flat, torch.zeros(5, 7), torch.zeros(1, 1)]


def _nn_case(case):
    rng = np.random.default_rng(5)
    words = lambda n: rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)  # noqa: E731
    cand, kp = words(4097), words(500)
    mask = rng.random(500) >= 0.1
    if case == "ties":
        kp[250:] = kp[:250]
        cand[:1000] = kp[rng.integers(0, 500, 1000)]
    elif case == "ragged":
        cand = cand[:1023]
    elif case == "all_masked":
        mask[:] = False
    elif case == "wide":  # more keypoints than the default dynamic shared memory holds
        kp = words(3000)
        mask = rng.random(3000) >= 0.1
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (cand.view(np.int32), kp.view(np.int32), mask)]


@pytest.mark.gpu
def test_fast_nms_kernel_bit_exact(cuda):
    for img in _images():
        g = img.contiguous().to(cuda)
        before = kernels.FAST_NMS.launches
        got = fast.fast_nms(g)
        torch.cuda.synchronize()
        assert kernels.FAST_NMS.launches == before + 1
        assert torch.equal(got, fast.fast_nms_reference(g)), tuple(g.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "ties", "ragged", "all_masked", "wide"])
def test_hamming_nn_kernel_exact(cuda, case):
    args = [a.to(cuda) for a in _nn_case(case)]
    before = kernels.HAMMING_NN.launches
    got = matching.nearest_keypoints_packed(*args)
    want = matching.hamming_nn_reference(*args)
    torch.cuda.synchronize()
    assert kernels.HAMMING_NN.launches == before + 1
    assert torch.equal(got.kp_index, want.kp_index) and torch.equal(got.distance, want.distance)


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(65536, 512), (16384, 500), (16383, 37), (0, 500)])
def test_hamming_matrix_kernel_exact(cuda, C, N):
    """K3 at the shapes of chip_smoke.py's K3 phase: the parity bench's, the
    main path's, a ragged C and N, and an empty pool."""
    rng = np.random.default_rng(C + N)
    cand, kp = (torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(cuda)
                for n in (C, N))
    before = kernels.HAMMING_MATRIX.launches
    got = matching.hamming_matrix_packed(cand, kp)
    want = matching.hamming_matrix_reference(cand, kp)
    torch.cuda.synchronize()
    assert kernels.HAMMING_MATRIX.launches == before + (1 if C else 0)
    assert got.shape == (C, N) and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_detect_level_same_on_card_and_cpu(cuda):
    """The whole detect stage (K1 + Harris + stable top-k) picks the same
    keypoints on the card as the plain CPU path."""
    for img in _images()[:4]:
        a = fast.detect_level(img, 20.0, 17, 97)
        b = fast.detect_level(img.to(cuda), 20.0, 17, 97)
        for x, y in zip(a, b):
            assert torch.equal(x, y.cpu())
