"""Parity of the PyTorch port's frontend and both kernels' plain versions
against the JAX package.

Stated tolerances: pyramid <= 1e-2 per level (0-255 image); kernel K1's
plain version (single image and whole pyramid): identical keep masks,
scores rtol 1e-5 / atol 1e-4; `extract_features` against its per-level
path of two single-image detections: equal;
`detect_keypoints`: the same keypoint set; kernel K2's plain version and
the projection matcher: exact.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.frontend import fast as jfast
from qsp_slam_tpu.frontend import matcher as jmatcher
from qsp_slam_tpu.frontend import orb as jorb
from qsp_slam_tpu.frontend import pyramid as jpyr
from qsp_slam_tpu.ops.fast_pallas import fast_score_nms_pallas
from qsp_slam_tpu.ops.hamming import hamming_matrix_packed
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.frontend import fast as tfast
from qsp_slam_tpu_torch.frontend import matcher as tmatcher
from qsp_slam_tpu_torch.frontend import orb as torb
from qsp_slam_tpu_torch.frontend import pyramid as tpyr
from qsp_slam_tpu_torch.ops import fast_nms
from qsp_slam_tpu_torch.ops.fast_nms import (
    fast_score_nms,
    fast_score_nms_plain,
    fast_score_nms_pyramid,
)
from qsp_slam_tpu_torch.ops.hamming import hamming_packed, hamming_packed_plain
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)


def T(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def popcount_rows(a: np.ndarray) -> np.ndarray:
    """Per-row popcount of (N, 8) 32-bit words, in numpy."""
    return np.unpackbits(np.ascontiguousarray(a).view(np.uint8), axis=1).sum(axis=1)


@pytest.fixture(scope="module")
def gray8():
    """One rendered 480x640 frame of the synthetic room as uint8."""
    cfg = TrackingConfig()
    room = make_room(device="cpu")
    g, _ = render_frame(room, orbit_trajectory(6)[5], cfg.intr)
    return np.clip(np.round(g.numpy()), 0, 255).astype(np.uint8)


def _test_ops_image(rng, H=96, W=128):
    """The image of the JAX package's own Pallas FAST test."""
    img = rng.normal(120.0, 40.0, (H, W)).astype(np.float32)
    for (y, x) in [(20, 30), (50, 90), (70, 40)]:
        img[y - 2 : y + 3, x - 2 : x + 3] = 30.0
        img[y, x] = 240.0
    return np.clip(img, 0, 255)


def assert_same_nms(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy() > 0, ref > 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


class TestPyramid:
    def test_blur(self, gray8):
        img = gray8.astype(np.float32)
        got = tpyr.gaussian_blur(torch.from_numpy(img))
        np.testing.assert_allclose(got.numpy(), np.asarray(jpyr.gaussian_blur(jnp.asarray(img))), atol=1e-3)

    def test_levels(self, gray8):
        img = gray8.astype(np.float32)
        cfg = jpyr.PyramidConfig()
        ref = jpyr.build_pyramid(jnp.asarray(img), cfg)
        got = tpyr.build_pyramid(torch.from_numpy(img), tpyr.PyramidConfig(*cfg))
        assert len(got) == len(ref) == 8
        for g, r in zip(got, ref):
            assert tuple(g.shape) == tuple(r.shape)
            assert float(np.abs(g.numpy() - np.asarray(r)).max()) <= 1e-2


class TestFastNms:
    """Kernel K1's plain version against both JAX formulations."""

    @pytest.mark.parametrize("t", [20.0, 7.0])
    def test_plain_matches_xla_formulation(self, gray8, rng, t):
        levels = tpyr.build_pyramid(torch.from_numpy(gray8.astype(np.float32)), tpyr.PyramidConfig())
        # Level 0 of a uint8 frame has integer scores; level 5 is resampled.
        for img in (levels[5], torch.from_numpy(_test_ops_image(rng))):
            ref = jfast.nms3x3(jfast.fast_score(jnp.asarray(img.numpy()), t))
            assert_same_nms(fast_score_nms_plain(img, t), ref)

    def test_plain_matches_pallas_interpret(self, rng):
        img = _test_ops_image(rng)
        got = fast_score_nms_plain(torch.from_numpy(img), 20.0)
        assert_same_nms(got, fast_score_nms_pallas(jnp.asarray(img), 20.0, interpret=True))
        assert int((got > 0).sum()) >= 3  # the planted corners fire

    def test_wrapper_on_cpu_takes_plain_and_launches_nothing(self, rng):
        img = torch.from_numpy(_test_ops_image(rng))
        before = fast_score_nms_pyramid.launches
        assert torch.equal(fast_score_nms(img, 20.0), fast_score_nms_plain(img, 20.0))
        assert fast_score_nms_pyramid.launches == before
        with pytest.raises(ValueError):
            fast_score_nms(img.double(), 20.0)

    @pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
    def test_pyramid_matches_jax_on_every_level(self, gray8, reference):
        """One call over a rendered 8-level pyramid at t = 20 and 7 against
        the JAX package, level by level, fed the same level images."""
        levels = tpyr.build_pyramid(torch.from_numpy(gray8.astype(np.float32)), tpyr.PyramidConfig())
        ths = (20.0, 7.0)
        got = fast_score_nms_pyramid(levels, ths)
        assert len(got) == len(levels) == 8
        for img, maps in zip(levels, got):
            assert len(maps) == len(ths)
            for m, t in zip(maps, ths):
                x = jnp.asarray(img.numpy())
                if reference == "xla":
                    ref = jfast.nms3x3(jfast.fast_score(x, t))
                else:
                    ref = fast_score_nms_pallas(x, t, interpret=True)
                assert m.shape == img.shape
                assert_same_nms(m, ref)
        assert int((got[0][0] > 0).sum()) > 30 and int((got[0][1] > 0).sum()) > int((got[0][0] > 0).sum())

    def test_pyramid_launch_struct(self):
        """The struct the kernel reads: every level's image pointer, shape
        and first tile, and one pointer per map into the flat buffer, each
        at the offset of the view returned for it."""
        shapes = ((480, 640), (37, 53), (7, 300))
        plan = fast_nms._plan(shapes, (20.0, 7.0))
        assert ctypes.sizeof(fast_nms._Level) == 40 and ctypes.sizeof(fast_nms._Pyramid) == 664
        base = 1 << 40
        p = fast_nms._launch_struct(plan, [1000, 2000, 3000], base)
        assert (p.n_levels, p.n_thresholds, list(p.t)) == (3, 2, [20.0, 7.0])
        # Tiles of 32 x 16: 30 x 20, 3 x 2 and 1 x 10 of them.
        first = [0, 600, 606]
        assert p.n_tiles == 616
        offset = 0
        for i, (H, W) in enumerate(shapes):
            lv = p.lv[i]
            assert (lv.img, lv.H, lv.W, lv.first_tile) == (1000 * (i + 1), H, W, first[i])
            for j in range(2):
                shape, stride, off = plan.views[i][j]
                assert (shape, stride, off) == ((H, W), (W, 1), offset)
                assert lv.out[j] == base + 4 * offset
                offset += H * W
        assert plan.numel == offset
        assert plan.template.lv[0].img is None  # the cached template keeps no pointer

    def test_pyramid_on_cpu_launches_nothing_and_rejects_bad_levels(self, rng):
        imgs = [torch.from_numpy(_test_ops_image(rng))]
        imgs += [torch.from_numpy(rng.uniform(0, 255, s).astype(np.float32)) for s in ((37, 53), (8, 8))]
        before = fast_score_nms_pyramid.launches
        got = fast_score_nms_pyramid(imgs, (20.0,))
        assert fast_score_nms_pyramid.launches == before
        for img, (m,) in zip(imgs, got):
            assert torch.equal(m, fast_score_nms_plain(img, 20.0))
        bad = [
            [imgs[0], imgs[1].double()],  # not float32
            [imgs[0], imgs[0].t()],  # not contiguous
            [imgs[0][None]],  # not (H, W)
            [],  # no level
            imgs * 6,  # more than 16 levels
        ]
        for levels in bad:
            with pytest.raises(ValueError):
                fast_score_nms_pyramid(levels, (20.0, 7.0))
        with pytest.raises(ValueError):
            fast_score_nms_pyramid(imgs, (20.0, 7.0, 5.0))
        assert fast_score_nms_pyramid.launches == before

    @pytest.mark.parametrize("t", [20.0, 7.0])
    def test_detect_keypoints_same_set(self, gray8, t):
        img = gray8.astype(np.float32)
        ref = jfast.detect_keypoints(jnp.asarray(img), t, 300)
        got = tfast.detect_keypoints(torch.from_numpy(img), t, 300)
        rv = np.asarray(ref.valid)
        gv = got.valid.numpy()
        assert rv.sum() == gv.sum() > 30
        ref_set = {tuple(p) for p in np.asarray(ref.xy)[rv]}
        got_set = {tuple(p) for p in got.xy.numpy()[gv]}
        assert got_set == ref_set

    def test_topk_ties_take_lower_index(self):
        x = torch.tensor([3.0, 5.0, 5.0, 1.0, 5.0, 3.0])
        vals, idx = tfast.topk_stable(x, 4)
        assert idx.tolist() == [1, 2, 4, 0]
        assert vals.tolist() == [5.0, 5.0, 5.0, 3.0]


class TestExtractFeatures:
    """The whole extractor is held to the JAX one on a rendered frame in
    `test_torch_slam.py::TestTracking::test_process_frame`."""

    def test_split_selection_equals_per_level_detection(self, gray8):
        """`extract_features` (one pyramid call, then a selection per score
        map) gives the features of two single-image detections per level."""
        cfg = torb.OrbConfig(num_features=1000)
        img = torch.from_numpy(gray8.astype(np.float32))
        got = torb.extract_features(img, cfg)
        pyr = tpyr.build_pyramid(img, cfg.pyramid)
        xy, resp, valid, ang, bits = [], [], [], [], []
        for lv, (im, budget) in enumerate(zip(pyr, torb._per_level_budget(cfg))):
            kp = tfast.detect_keypoints(im, cfg.fast_threshold, budget, cfg.cell, cfg.cell_cap)
            kp_min = tfast.detect_keypoints(im, cfg.fast_threshold_min, budget, cfg.cell, cfg.cell_cap)
            if int(kp.valid.sum()) < budget // 2:
                kp = kp_min
            a = torb.compute_orientation(im, kp.xy)
            xy.append(kp.xy * cfg.pyramid.scales[lv])
            resp.append(kp.score)
            valid.append(kp.valid)
            ang.append(a)
            bits.append(torb.compute_descriptors(tpyr.gaussian_blur(im), kp.xy, a)[0])
        for g, r in zip((got.xy, got.response, got.valid, got.angle, got.desc_bits),
                        (xy, resp, valid, ang, bits)):
            assert torch.equal(g, torch.cat(r))
        assert int(got.valid.sum()) > 300

    def test_per_level_budget(self):
        for n in (500, 1000, 4000):
            cfg = jorb.OrbConfig(num_features=n)
            assert torb._per_level_budget(torb.OrbConfig(num_features=n)) == jorb._per_level_budget(cfg)

    def test_windows_clamp_inside(self, rng):
        img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
        xy = np.array([[0.0, 0.0], [79.0, 59.0], [40.2, 30.7], [3.6, 55.1]], np.float32)
        ref = jorb.extract_windows(jnp.asarray(img), jnp.asarray(xy), 15)
        got = torb.extract_windows(torch.from_numpy(img), torch.from_numpy(xy), 15)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


class TestHamming:
    """Kernel K2's plain version and the matcher built on it."""

    def test_plain_matches_pallas_interpret(self, rng):
        A, B = 70, 130  # not tile-aligned: the ragged edges
        a = rng.integers(0, 2**32, (A, 8), dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2**32, (B, 8), dtype=np.uint64).astype(np.uint32)
        ref = np.asarray(hamming_matrix_packed(jnp.asarray(a), jnp.asarray(b), interpret=True))
        got = hamming_packed_plain(T(a), T(b))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert torch.equal(hamming_packed(T(a), T(b)), got)

    def test_packed_equals_pm_matmul_on_pm_rows(self, rng):
        pa = rng.choice(np.int8([-1, 1]), size=(90, 256))
        pb = rng.choice(np.int8([-1, 1]), size=(110, 256))
        ref = np.asarray(jmatcher.hamming_matrix(jnp.asarray(pa), jnp.asarray(pb)))
        got = tmatcher.hamming_matrix(tmatcher.pack_pm(T(pa)), tmatcher.pack_pm(T(pb)))
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_wrapper_checks_inputs(self):
        with pytest.raises(ValueError):
            hamming_packed(torch.zeros(3, 8, dtype=torch.int64), torch.zeros(3, 8, dtype=torch.int32))
        with pytest.raises(ValueError):
            hamming_packed(torch.zeros(3, 4, dtype=torch.int32), torch.zeros(3, 8, dtype=torch.int32))


def _projection_problem(rng, A=300, B=400):
    """Map points near features with noisy copies of their descriptors, so
    windows, ratio tests and duplicate claims all occur."""
    feat_xy = rng.uniform([0, 0], [640, 480], (B, 2)).astype(np.float32)
    feat_oct = rng.integers(0, 8, B).astype(np.int32)
    feat_pm = rng.choice(np.int8([-1, 1]), size=(B, 256))
    feat_valid = rng.random(B) < 0.95
    src = rng.integers(0, B, A)
    proj_uv = (feat_xy[src] + rng.normal(0, 6.0, (A, 2))).astype(np.float32)
    proj_oct = np.clip(feat_oct[src] + rng.integers(-1, 2, A), 0, 7).astype(np.int32)
    proj_pm = feat_pm[src].copy()
    flips = rng.random((A, 256)) < rng.uniform(0.02, 0.35, (A, 1))
    proj_pm[flips] *= -1
    proj_valid = rng.random(A) < 0.9
    radius = (12.0 * 1.2 ** proj_oct.astype(np.float32)).astype(np.float32)
    return dict(proj_uv=proj_uv, proj_valid=proj_valid, proj_pm=proj_pm, proj_octave=proj_oct,
                feat_xy=feat_xy, feat_valid=feat_valid, feat_pm=feat_pm, feat_octave=feat_oct,
                radius=radius)


class TestMatcher:
    @pytest.mark.parametrize("scale", [1.0, 2.0])
    def test_search_by_projection_and_resolve(self, rng, scale):
        p = _projection_problem(rng)
        B = p["feat_xy"].shape[0]
        ref = jmatcher.search_by_projection(
            proj_uv=jnp.asarray(p["proj_uv"]), proj_valid=jnp.asarray(p["proj_valid"]),
            proj_desc_pm=jnp.asarray(p["proj_pm"]), proj_octave=jnp.asarray(p["proj_octave"]),
            feat_xy=jnp.asarray(p["feat_xy"]), feat_valid=jnp.asarray(p["feat_valid"]),
            feat_desc_pm=jnp.asarray(p["feat_pm"]), feat_octave=jnp.asarray(p["feat_octave"]),
            radius_per_row=jnp.asarray(p["radius"] * scale),
        )
        dist = tmatcher.hamming_matrix(tmatcher.pack_pm(T(p["proj_pm"])), tmatcher.pack_pm(T(p["feat_pm"])))
        got = tmatcher.search_by_projection(
            proj_uv=T(p["proj_uv"]), proj_valid=T(p["proj_valid"]), proj_octave=T(p["proj_octave"]),
            feat_xy=T(p["feat_xy"]), feat_valid=T(p["feat_valid"]), feat_octave=T(p["feat_octave"]),
            radius_per_row=T(p["radius"] * scale), dist=dist,
        )
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert int(got.valid.sum()) > 50
        ref_r = jmatcher.resolve_duplicates(ref, B)
        got_r = tmatcher.resolve_duplicates(got, B)
        for g, r in zip(got_r, ref_r):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        # Some claims were duplicates and were resolved away.
        assert int(got_r.valid.sum()) < int(got.valid.sum())

    def test_masked_best_match_ratio(self, rng):
        dist = rng.integers(0, 120, (60, 80)).astype(np.int32)
        mask = rng.random((60, 80)) < 0.3
        for max_dist, ratio in ((50, 1.0), (100, 0.9)):
            ref = jmatcher.masked_best_match(jnp.asarray(dist), jnp.asarray(mask), max_dist, ratio)
            got = tmatcher.masked_best_match(T(dist), T(mask), max_dist, ratio)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
