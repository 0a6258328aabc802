"""The port's NVS helpers against the JAX package: geometry, warping,
epipolar attention (fast_dit_torch/nvs/{geometry,warp,epipolar}.py against
`fast_dit_tpu/nvs/`), the metrics, pose I/O and DINO loading (the port's
own copies of modules that import no JAX), viz and video, and the two CLIs
(`python -m fast_dit_torch.nvs_demo`, `python -m
fast_dit_torch.evaluate_samples`) against `tools/nvs_demo.py` and
`tools/evaluate_samples.py`.

Inputs are numpy from a seed. Tolerances: fp32 geometry and attention
within 1e-5 of max |JAX| (the rank-2 projection through an SVD, unique
whatever the singular vectors' signs, too); the numpy copies equal. A warp
rounds projected pixel positions, so a one-ulp difference in a position
can move a pixel: on the demo's planar scene the masks and the warped
images are equal, and on a seeded random-depth scene every target pixel
that differs traces to a source point whose position lies within 1e-5 of
a rounding boundary (and the warped depth, a sum of products rounded
apart from XLA's, is within 1e-6 of max elsewhere).
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_nvs_extras import _STUB_HUBCONF

from fast_dit_tpu.nvs import dino as jax_dino
from fast_dit_tpu.nvs import epipolar as jax_epipolar
from fast_dit_tpu.nvs import geometry as jax_geometry
from fast_dit_tpu.nvs import metrics as jax_metrics
from fast_dit_tpu.nvs import pose_io as jax_pose_io
from fast_dit_tpu.nvs import warp as jax_warp
from fast_dit_tpu.utils import video as jax_video
from fast_dit_tpu.utils import viz as jax_viz
from fast_dit_torch import evaluate_samples, nvs_demo
from fast_dit_torch.nvs import dino, epipolar, geometry, metrics, pose_io, warp
from fast_dit_torch.utils import video, viz
from fast_dit_torch.utils.image import encode_png
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
BOUNDARY = 1e-5  # pixels: a position this near x.5 may round either way
K_NP = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), scale)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _pose(seed):
    rs = np.random.RandomState(seed)
    q = np.array([1.0, *(0.1 * rs.randn(3))], np.float32)
    return q, (0.3 * rs.randn(3)).astype(np.float32)


def test_geometry_matches_jax():
    q1, t1 = _pose(0)
    q2, t2 = _pose(1)
    qs = np.stack([q1, q2])
    _close(geometry.quaternion_to_rotation_matrix(*_t(qs)),
           jax_geometry.quaternion_to_rotation_matrix(qs))
    _close(geometry.skew(*_t(qs[:, 1:])), jax_geometry.skew(qs[:, 1:]))
    R1, R2 = (np.asarray(jax_geometry.quaternion_to_rotation_matrix(q)) for q in (q1, q2))
    want_pose = jax_geometry.relative_pose(R1, t1, R2, t2)
    got_pose = geometry.relative_pose(*_t(R1, t1, R2, t2))
    for g, w in zip(got_pose, want_pose):
        _close(g, w)
    R_rel, t_rel = (np.asarray(a) for a in want_pose)
    _close(geometry.essential_matrix(*_t(R_rel, t_rel)), jax_geometry.essential_matrix(R_rel, t_rel))
    K2 = K_NP * np.array([[1.1, 1, 1.1], [1, 0.9, 0.9], [1, 1, 1]], np.float32)
    for rank2 in (True, False):
        F = geometry.fundamental_matrix(*_t(K_NP, K2, R_rel, t_rel), rank2_project=rank2)
        Fj = np.asarray(jax_geometry.fundamental_matrix(K_NP, K2, R_rel, t_rel,
                                                        rank2_project=rank2))
        _close(F, Fj)
    Fr = geometry.fundamental_matrix(*_t(K_NP, K2, R_rel, t_rel))
    assert abs(torch.linalg.det(Fr.double()).item()) < 1e-9  # rank 2
    pts = np.random.RandomState(2).rand(5, 2).astype(np.float32) * 16
    lines = geometry.epipolar_lines(Fr, *_t(pts))
    jlines = jax_geometry.epipolar_lines(Fj, pts)
    _close(lines, jlines)
    _close(geometry.point_line_distance(lines, *_t(pts)),
           jax_geometry.point_line_distance(np.asarray(jlines), pts))
    _close(geometry.epipolar_distance_map(Fr, 6, 5), jax_geometry.epipolar_distance_map(Fj, 6, 5))
    _close(geometry.epipolar_distance_map(Fr, 6, 5, threshold=1.0, softmax_temp=0.5),
           jax_geometry.epipolar_distance_map(Fj, 6, 5, threshold=1.0, softmax_temp=0.5))
    _close(geometry.plucker_coordinates(*_t(K_NP, R2, t2), 6, 5),
           jax_geometry.plucker_coordinates(K_NP, R2, t2, 6, 5))
    _close(geometry.raymap(*_t(K_NP, R2, t2), 6, 5), jax_geometry.raymap(K_NP, R2, t2, 6, 5))
    _close(geometry.scale_intrinsics(*_t(K_NP), 0.5, 2.0),
           jax_geometry.scale_intrinsics(jnp.asarray(K_NP), 0.5, 2.0))
    coords = np.random.RandomState(3).rand(4, 3, 2).astype(np.float32)
    _close(geometry.fourier_features(*_t(coords), 4, 8.0),
           jax_geometry.fourier_features(coords, 4, 8.0))


def _jax_demo_scene(size):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import nvs_demo as jax_demo
    finally:
        sys.path.pop(0)
    return jax_demo.make_scene(size)


def test_warps_match_jax_on_the_demo_scene():
    src, depth, K, (R1, t1), (R2, t2), d0 = _jax_demo_scene(32)
    psrc, pdepth, pK, (pR1, pt1), (pR2, pt2), _ = nvs_demo.make_scene(32)
    assert np.array_equal(src, psrc) and np.array_equal(depth, pdepth)
    for a, b in ((K, pK), (R2, pR2), (t2, pt2)):
        assert np.array_equal(np.asarray(a), b.numpy())
    R_rel, t_rel = jax_geometry.relative_pose(R1, t1, R2, t2)
    pR_rel, pt_rel = geometry.relative_pose(pR1, pt1, pR2, pt2)
    want = jax_warp.warp_image_by_depth(jnp.asarray(src), jnp.asarray(depth), K, K, R_rel, t_rel)
    got = warp.warp_image_by_depth(torch.from_numpy(src), torch.from_numpy(depth), pK, pK,
                                   pR_rel, pt_rel)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    H = jax_warp.homography_from_pose(K, K, R_rel, t_rel, plane_distance=d0)
    pH = warp.homography_from_pose(pK, pK, pR_rel, pt_rel, plane_distance=d0)
    _close(pH, H)
    want = jax_warp.warp_image_homography(jnp.asarray(src), H)
    got = warp.warp_image_homography(torch.from_numpy(src), pH)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert float(warp.valid_pixel_ratio(got[1])) == float(jax_warp.valid_pixel_ratio(want[1]))


def _near_boundary(uv):
    return (np.abs(np.abs(uv - np.floor(uv)) - 0.5) <= BOUNDARY).any(axis=-1)


def test_warps_on_a_random_depth_scene_differ_only_at_rounding_boundaries():
    rs = np.random.RandomState(11)
    h = w = 32
    depth = (1.0 + 2.0 * rs.rand(h, w)).astype(np.float32)
    depth[rs.rand(h, w) < 0.05] = 0.0  # no depth: never scattered
    img = rs.rand(h, w, 3).astype(np.float32)
    K = np.array([[30.0, 0, 16], [0, 28.0, 15.5], [0, 0, 1]], np.float32)
    R = np.asarray(jax_geometry.quaternion_to_rotation_matrix(
        np.array([1.0, 0.02, -0.05, 0.01], np.float32)))
    t = np.array([0.2, -0.1, 0.05], np.float32)
    want_img, want_mask = (np.asarray(a) for a in jax_warp.warp_image_by_depth(
        jnp.asarray(img), jnp.asarray(depth), K, K, R, t))
    want_d, want_dmask = (np.asarray(a) for a in jax_warp.warp_depth_map(
        jnp.asarray(depth), K, K, R, t))
    timg, tdepth, tK, tR, tt = _t(img, depth, K, R, t)
    got_img, got_mask = (a.numpy() for a in warp.warp_image_by_depth(timg, tdepth, tK, tK, tR, tt))
    got_d, got_dmask = (a.numpy() for a in warp.warp_depth_map(tdepth, tK, tK, tR, tt))
    assert np.array_equal(got_mask, got_dmask) and np.array_equal(want_mask, want_dmask)
    # the positions agree to rounding; where they round to other pixels the
    # position sits on a boundary, and only those points' targets may differ
    pts = jax_warp.transform_points(jax_warp.depth_to_points(depth, K).reshape(-1, 3), R, t)
    juv = np.asarray(jax_warp.project_points(pts, K)[0])
    puv = warp.project_points(warp.transform_points(
        warp.depth_to_points(tdepth, tK).reshape(-1, 3), tR, tt), tK)[0].numpy()
    assert np.abs(juv - puv).max() <= BOUNDARY
    moved = (np.round(juv) != np.round(puv)).any(axis=-1)
    assert _near_boundary(puv[moved]).all()
    allowed = np.zeros(h * w, bool)
    for uv in (juv[moved], puv[moved]):
        u, v = np.round(uv).astype(np.int64).T
        inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        allowed[(v * w + u)[inb]] = True
    differ = ((got_mask != want_mask) | (got_img != want_img).any(-1)).reshape(-1)
    assert not (differ & ~allowed).any()
    # the warped depth is the transformed z, whose sum of three products
    # rounds apart from XLA's by an ulp: elsewhere within 1e-6 of max
    _close(got_d.reshape(-1)[~allowed], want_d.reshape(-1)[~allowed], 1e-6)
    assert got_mask.mean() > 0.5  # a real warp, not an empty one


def test_epipolar_matches_jax():
    mask = (np.random.RandomState(5).rand(2, 32, 32) > 0.5).astype(np.float32)
    _close(epipolar.patchify_attention_mask(*_t(mask), 16),
           jax_epipolar.patchify_attention_mask(mask, 16))
    with pytest.raises(ValueError, match="divisible"):
        epipolar.patchify_attention_mask(torch.zeros(1, 30, 32), 16)
    Fs = []
    for seed in (0, 1):
        q, t = _pose(seed)
        R = np.asarray(jax_geometry.quaternion_to_rotation_matrix(q))
        Fs.append(np.asarray(jax_geometry.fundamental_matrix(K_NP, K_NP, R, t)))
    Fs = np.stack(Fs)
    _close(epipolar.epipolar_weight_map(*_t(Fs), 8, 8, threshold=1.0),
           jax_epipolar.epipolar_weight_map(Fs, 8, 8, threshold=1.0))
    _close(epipolar.epipolar_weight_map(*_t(Fs[0]), 8, 8),
           jax_epipolar.epipolar_weight_map(Fs[0], 8, 8))
    rs = np.random.RandomState(6)
    f_src, f_tar = (rs.randn(2, 4, 8, 8).astype(np.float32) for _ in range(2))
    for aff in (False, True):
        _close(epipolar.epipolar_attention(*_t(f_tar, f_src, Fs), threshold=0.5,
                                           use_affinity=aff),
               jax_epipolar.epipolar_attention(f_tar, f_src, Fs, threshold=0.5,
                                               use_affinity=aff))


def test_metrics_equal_jax():
    rs = np.random.RandomState(7)
    a = (rs.rand(24, 24, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int64) + rs.randint(-20, 20, a.shape), 0, 255).astype(np.uint8)
    for fn in ("psnr", "ssim"):
        assert getattr(metrics, fn)(a, b) == getattr(jax_metrics, fn)(a, b)
    assert metrics.psnr(a, a) == float("inf")
    x, y = rs.randn(40, 6), rs.randn(40, 6) + 0.3
    feat = lambda imgs: imgs  # noqa: E731
    assert metrics.compute_fid(x, y, feat) == jax_metrics.compute_fid(x, y, feat)
    assert metrics.compute_kid(x, y, feat, 3, 20) == jax_metrics.compute_kid(x, y, feat, 3, 20)
    probs = rs.dirichlet(np.ones(5), size=30)
    assert metrics.inception_score(probs, 3) == jax_metrics.inception_score(probs, 3)
    F = np.asarray(jax_geometry.fundamental_matrix(K_NP, K_NP, np.eye(3, dtype=np.float32),
                                                   np.array([1.0, 0, 0], np.float32)))
    p1, p2 = rs.rand(6, 2) * 16, rs.rand(6, 2) * 16
    assert np.array_equal(metrics.symmetric_epipolar_distance(p1, p2, F),
                          jax_metrics.symmetric_epipolar_distance(p1, p2, F))
    img = (rs.rand(64, 64, 3) * 255).astype(np.uint8)
    assert metrics.compute_tsed(img, img, F) == jax_metrics.compute_tsed(img, img, F)
    if importlib.util.find_spec("lpips") is None:
        with pytest.raises(ImportError):
            metrics.compute_lpips(np.zeros((1, 3, 8, 8)), np.zeros((1, 3, 8, 8)))


def test_pose_io_equals_jax(tmp_path):
    rows = []
    for i in range(3):
        pose = np.eye(4)
        pose[:3, 3] = [i * 0.1, 0.2, -0.1 * i]
        rows.append(" ".join(map(str, [i, 500.0, 501.0, 320.0, 240.0]
                                  + pose.reshape(-1)[:12].tolist())))
    (tmp_path / "poses.txt").write_text("\n".join(rows))
    for inv in (True, False):
        got = pose_io.convert_poses_to_json(str(tmp_path / "poses.txt"),
                                            str(tmp_path / "a.json"), invert_extrinsics=inv)
        want = jax_pose_io.convert_poses_to_json(str(tmp_path / "poses.txt"),
                                                 str(tmp_path / "b.json"), invert_extrinsics=inv)
        assert got == want
        assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    frames = tmp_path / "rgb"
    frames.mkdir()
    for ts in ("100", "200"):
        (frames / f"{ts}.png").write_bytes(b"")
    entries = [{"timestamp": ts, "intrinsics": [[500.0, 0, 320.0], [0, 501.0, 240.0], [0, 0, 1]],
                "pose": np.eye(4).tolist()} for ts in ("100", "200", "300")]
    (tmp_path / "scene.json").write_text(json.dumps(entries))
    assert (pose_io.write_realestate_txt(str(tmp_path / "scene.json"), str(frames),
                                         str(tmp_path / "a.txt"))
            == jax_pose_io.write_realestate_txt(str(tmp_path / "scene.json"), str(frames),
                                                str(tmp_path / "b.txt")) == 2)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    assert np.array_equal(pose_io.orb_to_blender(np.eye(4)), jax_pose_io.orb_to_blender(np.eye(4)))


def test_dino_loads_a_local_stub_as_jax_does(tmp_path):
    img = np.full((2, 28, 42, 3), 128, np.uint8)
    img[0, :5] = 3
    assert np.array_equal(dino.preprocess_images(img), jax_dino.preprocess_images(img))
    (tmp_path / "hubconf.py").write_text(_STUB_HUBCONF)
    for layers in ((-1,), (-1, -3)):
        got = dino.load_dino(layers=layers, hub_dir=str(tmp_path), device="cpu")(img)
        want = jax_dino.load_dino(layers=layers, hub_dir=str(tmp_path))(img)
        assert got.shape == (2, 4 * len(layers), 2, 3) and np.array_equal(got, want)
    with pytest.raises(ValueError, match="negative indices"):
        dino.load_dino(layers=(0,), hub_dir=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="never downloaded"):
        dino.load_dino(hub_dir=str(tmp_path / "missing"), device="cpu")
    assert np.array_equal(dino.random_dino_features(2, 4, 8, seed=3),
                          jax_dino.random_dino_features(2, 4, 8, seed=3))


def test_viz_and_video_equal_jax(tmp_path):
    rs = np.random.RandomState(8)
    a, b = rs.rand(16, 16, 3) * 255, rs.rand(16, 16, 3) * 255
    assert np.array_equal(viz.error_heatmap(a, b), jax_viz.error_heatmap(a, b))
    d = rs.rand(8, 8)
    assert np.array_equal(viz.depth_to_color(d), jax_viz.depth_to_color(d))
    assert np.array_equal(viz.colorize(d, vmin=0.2, vmax=0.5), jax_viz.colorize(d, vmin=0.2,
                                                                                vmax=0.5))
    img = (rs.rand(32, 32, 3) * 255).astype(np.uint8)
    assert np.array_equal(viz.attention_overlay(img, d), jax_viz.attention_overlay(img, d))
    feats = rs.randn(20, 5)
    assert np.array_equal(viz.embed_features_2d(feats), jax_viz.embed_features_2d(feats))
    with pytest.raises(ValueError, match="unknown method"):
        viz.embed_features_2d(feats, method="pca")
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        (frames / f"{i:03d}.png").write_bytes(encode_png(np.full((16, 16, 3), 60 * i, np.uint8)))
    assert video.images_to_video(str(frames), str(tmp_path / "a.mp4"), fps=5) == 3
    assert jax_video.images_to_video(str(frames), str(tmp_path / "b.mp4"), fps=5) == 3
    assert (tmp_path / "a.mp4").stat().st_size > 0
    with pytest.raises(ValueError, match="no .jpg frames"):
        video.images_to_video(str(frames), str(tmp_path / "c.mp4"), ext=".jpg")


def _jax_demo_fields(size):
    """The JAX demo's deterministic report fields (tools/nvs_demo.py:141-213):
    its own scene, warps and mask."""
    from fast_dit_tpu.nvs import inpaint as jax_inpaint
    src, depth, K, (R1, t1), (R2, t2), d0 = _jax_demo_scene(size)
    R_rel, t_rel = jax_geometry.relative_pose(R1, t1, R2, t2)
    H = jax_warp.homography_from_pose(K, K, R_rel, t_rel, plane_normal=jnp.array([0.0, 0.0, 1.0]),
                                      plane_distance=d0)
    gt, gt_mask = (np.asarray(a) for a in jax_warp.warp_image_homography(jnp.asarray(src), H))
    warped, cover = jax_warp.warp_image_by_depth(jnp.asarray(src), jnp.asarray(depth), K, K,
                                                 R_rel, t_rel)
    warped = np.asarray(warped)
    holes = jax_inpaint.mask_from_black_pixels(np.clip(warped * 255, 0, 255).astype(np.uint8))
    keep = ~holes & gt_mask
    return {"coverage": round(float(jax_warp.valid_pixel_ratio(cover)), 4),
            "hole_fraction": round(float(holes.mean()), 4),
            "psnr_warped_region": round(float(-10 * np.log10(np.maximum(
                np.mean((gt[keep] - warped[keep]) ** 2), 1e-12))), 3)}


@pytest.mark.parametrize("extra", [[], ["--nvs-model", "--jump-n", "2"]],
                         ids=["dit", "ditnvs"])
def test_nvs_demo_cli_on_the_cpu_matches_the_jax_demo(tmp_path, extra):
    out = tmp_path / "demo"
    rc = nvs_demo.main(["--device", "cpu", "--size", "32", "--num-sampling-steps", "6",
                        "--out-dir", str(out), *extra])
    assert rc == 0
    report = json.loads((out / "report.json").read_text())
    want = _jax_demo_fields(32)
    assert {k: report[k] for k in want} == want
    assert report["model"].startswith("DiTNVS" if extra else "DiT (")
    assert np.isfinite([report["psnr_full"], report["ssim_full"]]).all()
    for f in ("src.png", "gt_target.png", "warped_holes.png", "inpainted.png", "hole_mask.png",
              "depth.png", "error_heatmap.png"):
        assert (out / f).stat().st_size > 0, f


def test_nvs_demo_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nvs_demo.main(["--size", "32", "--out-dir", str(tmp_path / "demo")])


def test_evaluate_samples_cli_matches_jax(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import evaluate_samples as jax_eval
    finally:
        sys.path.pop(0)
    rs = np.random.RandomState(9)
    gen = (rs.rand(12, 16, 16, 3) * 255).astype(np.uint8)
    ref = np.clip(gen.astype(np.int64) + rs.randint(-30, 30, gen.shape), 0, 255).astype(np.uint8)
    np.savez(tmp_path / "gen.npz", arr_0=gen)
    folder = tmp_path / "ref"
    folder.mkdir()
    for i, im in enumerate(ref):
        (folder / f"{i:03d}.png").write_bytes(encode_png(im))
    F = np.stack([np.eye(3)] * 11)
    np.savez(tmp_path / "F.npz", arr_0=F)
    res = evaluate_samples.main(["--generated", str(tmp_path / "gen.npz"), "--reference",
                                 str(folder), "--paired", "--feature-net", "random",
                                 "--tsed-poses", str(tmp_path / "F.npz")])
    feature_fn, logits_fn = jax_eval.make_random_projection_fns()
    probs = logits_fn(gen)
    want = {"psnr": float(np.mean([jax_metrics.psnr(ref[i], gen[i]) for i in range(12)])),
            "ssim": float(np.mean([jax_metrics.ssim(ref[i], gen[i]) for i in range(12)])),
            "fid": jax_metrics.compute_fid(ref, gen, feature_fn),
            "kid": jax_metrics.compute_kid(ref, gen, feature_fn)[0],
            "inception_score": jax_metrics.inception_score(
                np.clip(probs / probs.sum(1, keepdims=True), 1e-12, 1))[0]}
    assert {k: res[k] for k in want} == want
    assert ("lpips" in res) == (importlib.util.find_spec("lpips") is not None)
    # without local Inception weights the FID family is skipped, as in JAX
    capsys.readouterr()
    res = evaluate_samples.main(["--generated", str(tmp_path / "gen.npz"), "--reference",
                                 str(tmp_path / "gen.npz")])
    assert "fid" not in res
    assert "InceptionV3 unavailable" in capsys.readouterr().err
    with pytest.raises(ValueError, match="different pooled feature dims"):
        fn, _ = evaluate_samples.make_random_projection_fns()
        fn(gen)
        fn(np.zeros((2, 12, 12, 3), np.uint8))
