"""The port's CUDA kernels against their plain torch versions, on a card.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these skip without a
device.  The file imports neither jax nor the JAX package, so it also runs
on a machine without jax:

    python3 -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

Tolerance: none - K1 uses only subtraction, min and max, K2 and K3 only
integers.  K1 and K2 also run on S streams at once (their custom ops and
the ops' vmap rules): exact per stream, one launch.
"""

import numpy as np
import pytest
import torch

from rgbd_visualodometry_tpu_torch import kernels
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.ops import fast, image as im, matching


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain K2 matmul stays exact
    return torch.device("cuda")


def _images():
    sc = synthetic.SyntheticScene(width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6)
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
    elif case == "n37":  # N not a multiple of the 8-keypoint tile, C of the 128-row block
        kp, mask, cand = kp[:37], mask[:37], cand[:1000]
    elif case == "main":  # the main path's shape
        cand = words(16384)
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
def test_fast_nms_pyramid_one_launch(cuda):
    """All levels of a pyramid in one launch: an odd-sized 641x479 frame's
    8 levels, a table with 1x1 and 5x7 levels, and 10 levels (two launches
    of at most 8)."""
    rng = np.random.default_rng(1)
    odd = torch.from_numpy(rng.uniform(0, 255, (479, 641)).astype(np.float32))
    odd = im.gaussian_blur(odd, 7, 2.0)
    tables = [im.build_pyramid(odd, 8, 1.2), _images()[4:] + _images()[:2], im.build_pyramid(odd, 10, 1.2)]
    for levels, launches in zip(tables, (1, 1, 2)):
        g = [lv.contiguous().to(cuda) for lv in levels]
        before = kernels.FAST_NMS.launches
        got = fast.fast_nms_pyramid(g)
        torch.cuda.synchronize()
        assert kernels.FAST_NMS.launches == before + launches
        for a, lv in zip(got, g):
            assert torch.equal(a, fast.fast_nms_reference(lv)), tuple(lv.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "ties", "ragged", "all_masked", "wide", "n37", "main"])
def test_hamming_nn_kernel_exact(cuda, case):
    args = [a.to(cuda) for a in _nn_case(case)]
    before = kernels.HAMMING_NN.launches
    got = matching.nearest_keypoints_packed(*args)
    want = matching.hamming_nn_reference(*args)
    torch.cuda.synchronize()
    assert kernels.HAMMING_NN.launches == before + 1
    assert torch.equal(got.kp_index, want.kp_index) and torch.equal(got.distance, want.distance)


def _k3_case(C, N, ties=False):
    rng = np.random.default_rng(C + N)
    words = lambda n: rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)  # noqa: E731
    cand, kp = words(C), words(N)
    if ties:  # every keypoint twice, every candidate equal to a keypoint
        kp[N // 2:] = kp[: N - N // 2]
        cand = kp[np.arange(C) % N]
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in (cand, kp)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,N,ties", [
    (65536, 512, False), (16384, 500, False), (16383, 500, False), (16383, 37, False), (0, 500, False),
    (1000, 1, False), (1000, 7, False), (1000, 9, False), (1, 512, False), (16384, 3000, False),
    (1000, 0, False), (4096, 500, True),
])
def test_hamming_matrix_kernel_exact(cuda, C, N, ties):
    """K3 at the shapes of chip_smoke.py's K3 phase: the parity bench's, the
    main path's, ragged C, rows that are not 16-byte aligned (N = 1, 7, 9,
    37), C = 1, more keypoints than one shared-memory chunk, empty C and N,
    and a tie-heavy pool."""
    cand, kp = (a.to(cuda) for a in _k3_case(C, N, ties))
    before = kernels.HAMMING_MATRIX.launches
    got = matching.hamming_matrix_packed(cand, kp)
    want = matching.hamming_matrix_reference(cand, kp)
    torch.cuda.synchronize()
    assert kernels.HAMMING_MATRIX.launches == before + (1 if C and N else 0)
    assert got.shape == (C, N) and got.dtype == torch.int32
    assert torch.equal(got, want)
    if ties:
        assert (got[torch.arange(C), torch.arange(C) % N] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("C,N", [(16383, 500), (1000, 37), (1, 9), (100, 3000)])
def test_hamming_matrix_kernel_writes_only_its_output(cuda, C, N, offset):
    """K3's C entry on a view into a sentinel-filled buffer: every word
    outside [C, N] is left as it was.  At offset 1 word the output is not
    16-byte aligned, which takes the one-word store path."""
    cand, kp = (a.to(cuda) for a in _k3_case(C, N))
    pad = 64
    buf = torch.full((C * N + 2 * pad,), -7, dtype=torch.int32, device=cuda)
    out = buf[pad + offset : pad + offset + C * N]
    kernels.HAMMING_MATRIX.launch(cand, kp, C, N, out)
    torch.cuda.synchronize()
    assert (buf[: pad + offset] == -7).all() and (buf[pad + offset + C * N :] == -7).all()
    assert torch.equal(out.view(C, N), matching.hamming_matrix_reference(cand, kp))


@pytest.mark.gpu
def test_detect_level_same_on_card_and_cpu(cuda):
    """The whole detect stage (K1 + Harris + stable top-k) picks the same
    keypoints on the card as the plain CPU path."""
    for img in _images()[:4]:
        a = fast.detect_level(img, 20.0, 17, 97)
        b = fast.detect_level(img.to(cuda), 20.0, 17, 97)
        for x, y in zip(a, b):
            assert torch.equal(x, y.cpu())


def _stream_pyramids(S, cuda):
    """S odd-sized random images' 8-level pyramids, as ``[S, h, w]`` levels."""
    rng = np.random.default_rng(S)
    imgs = torch.from_numpy(rng.uniform(0, 255, (S, 121, 161)).astype(np.float32))
    pyrs = [im.build_pyramid(im.gaussian_blur(g, 7, 2.0), 8, 1.2) for g in imgs]
    return [torch.stack([p[i] for p in pyrs]).to(cuda) for i in range(8)]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3, 72])
def test_fast_nms_streams_exact(cuda, S):
    """K1 on S streams' 8-level pyramids: one launch, every stream's every
    level equal to the plain version."""
    levels = _stream_pyramids(S, cuda)
    before = kernels.FAST_NMS.launches
    flat = fast.fast_nms_streams(levels)
    torch.cuda.synchronize()
    assert kernels.FAST_NMS.launches == before + 1
    outs = torch.split(flat, [lv.shape[1] * lv.shape[2] for lv in levels], dim=1)
    for lv, out in zip(levels, outs):
        for s in range(S):
            assert torch.equal(out[s].view(lv.shape[1:]), fast.fast_nms_reference(lv[s])), (s, tuple(lv.shape))


@pytest.mark.gpu
@pytest.mark.parametrize("S,C", [(1, 16384), (3, 16383), (72, 1000)])
def test_hamming_nn_streams_exact(cuda, S, C):
    """K2 on S streams at once: one launch, each stream equal to the plain
    version, a ragged C and (S > 1) a stream with every keypoint masked."""
    rng = np.random.default_rng(S + C)
    words = lambda *s: torch.from_numpy(rng.integers(0, 2**32, s + (8,), dtype=np.uint64).astype(np.uint32).view(np.int32))  # noqa: E731
    cand, kp = words(S, C).to(cuda), words(S, 500).to(cuda)
    mask = torch.from_numpy(rng.random((S, 500)) >= 0.1).to(cuda)
    if S > 1:
        mask[1] = False
    before = kernels.HAMMING_NN.launches
    idx, dist = matching.hamming_nn_streams(cand, kp, mask)
    torch.cuda.synchronize()
    assert kernels.HAMMING_NN.launches == before + 1
    for s in range(S):
        want = matching.hamming_nn_reference(cand[s], kp[s], mask[s])
        assert torch.equal(idx[s], want.kp_index) and torch.equal(dist[s], want.distance), s


@pytest.mark.gpu
def test_vmap_rule_equals_single_launches(cuda):
    """K1 and K2 under torch.func.vmap over 3 streams: one launch each, the
    same results as a Python loop of single-stream launches."""
    levels = _stream_pyramids(3, cuda)
    before = kernels.FAST_NMS.launches
    got = torch.func.vmap(fast.fast_nms_pyramid)(levels)
    torch.cuda.synchronize()
    assert kernels.FAST_NMS.launches == before + 1
    for s in range(3):
        for a, b in zip([g[s] for g in got], fast.fast_nms_pyramid([lv[s] for lv in levels])):
            assert torch.equal(a, b)
    args = [a.to(cuda) for a in _nn_case("random")]
    cand = torch.stack([args[0], args[0].flip(0), args[0].roll(7, 0)])
    before = kernels.HAMMING_NN.launches
    got = torch.func.vmap(matching.nearest_keypoints_packed, in_dims=(0, None, None))(cand, args[1], args[2])
    torch.cuda.synchronize()
    assert kernels.HAMMING_NN.launches == before + 1
    for s in range(3):
        want = matching.nearest_keypoints_packed(cand[s].contiguous(), args[1], args[2])
        assert torch.equal(got.kp_index[s], want.kp_index) and torch.equal(got.distance[s], want.distance)


@pytest.mark.gpu
def test_batched_step_launches_each_kernel_once(cuda):
    """``MultiStreamVO`` on the card: every batch step launches K1 and K2
    once for all its streams."""
    from rgbd_visualodometry_tpu_torch import VOConfig
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO

    cfg = VOConfig(image_width=320, image_height=240, camera_fx=258.6, camera_fy=258.2, camera_cx=159.3,
                   camera_cy=127.6, number_of_features=300, level_pyramid=4, max_keyframes=32, max_mappoints=4096,
                   packed_matching=True, enable_local_optimization=True, ba_max_points=512)
    seqs = [synthetic.generate_sequence(3, scene=synthetic.SyntheticScene(
        width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6, seed=s)) for s in range(3)]
    vo = MultiStreamVO(cfg, 3)
    kernels.reset_counts()
    for i in range(3):
        out = vo.step(np.stack([q[i].rgb for q in seqs]), np.stack([q[i].depth for q in seqs]),
                      np.array([q[i].timestamp for q in seqs]))
    vo.finish()
    torch.cuda.synchronize()
    assert kernels.counts()["fast_nms"] == 3 and kernels.counts()["hamming_nn"] == 3, kernels.counts()
    assert bool(out.tracked.all())
