"""Device parity sweep: every exact-spec device kernel, compiled for the GPU,
against the same jitted op on the CPU (where CI proves it equals golden).

The ops are grouped into a handful of jit programs (one compile each). The
result goes to ``--out`` as JSON and a one-line summary to stdout; the exit
code is 1 when any op is outside its stated tolerance.

Usage:
    python probe_parity.py [--out parity.json]   # on a machine with a GPU
    python probe_parity.py --cpu-ref REF.npz     # (internal) the CPU half

The CPU half runs in a child process, before this process opens the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

H, W = 288, 512
N = 2


def build_inputs():
    rng = np.random.default_rng(20260819)
    gray = rng.integers(0, 256, (N, H, W), np.uint8)
    gray2 = rng.integers(0, 256, (N, H, W), np.uint8)
    bgrp = rng.integers(0, 256, (N, H, W * 3), np.uint8)
    hwc = rng.integers(0, 256, (H, W, 3), np.uint8)
    yuyv = rng.integers(0, 256, (N, H * W * 2), np.uint8)
    nv12 = rng.integers(0, 256, (N, H * W * 3 // 2), np.uint8)
    lut = rng.integers(0, 256, 256, np.uint8)
    mapx = (np.arange(W, dtype=np.float32)[None, :] * 0.93 + 7.1
            + 3 * np.sin(np.arange(H, dtype=np.float32)[:, None] / 11)).astype(np.float32)
    mapy = (np.arange(H, dtype=np.float32)[:, None] * 1.04 - 2.2
            + 2 * np.cos(np.arange(W, dtype=np.float32)[None, :] / 17)).astype(np.float32)
    return dict(gray=gray, gray2=gray2, bgrp=bgrp, hwc=hwc, yuyv=yuyv,
                nv12=nv12, lut=lut, mapx=mapx, mapy=mapy)


def compute_all():
    """Every op under jit, grouped into a few programs. Returns {name: np}."""
    import jax
    import jax.numpy as jnp

    from rustcv_tpu.ops import arith as A
    from rustcv_tpu.ops import color as C
    from rustcv_tpu.ops import features as FE
    from rustcv_tpu.ops import filters as F
    from rustcv_tpu.ops import hist as HI
    from rustcv_tpu.ops import resize as R
    from rustcv_tpu.ops import warp as WP

    ins = {k: jnp.asarray(v) for k, v in build_inputs().items()}
    out = {}

    @jax.jit
    def prog_filters(g, g2, lut):
        o = {}
        o["gaussian5"] = F.gaussian5_u8(g, has_channels=False)
        o["box3"] = F.box_blur_u8(g, 3)
        gx, gy = F.sobel3_gray(g)
        o["sobel_gx"], o["sobel_gy"] = gx, gy
        o["grad_mag"] = F.gradient_magnitude_u8(gx, gy)
        o["laplacian3"] = F.laplacian3(g)
        sx, sy = F.scharr3_gray(g)
        o["scharr_x"], o["scharr_y"] = sx, sy
        o["median3"] = F.median3_u8(g)
        o["median5"] = F.median_u8(g, 5)
        o["erode3"] = F.erode_u8(g, 3)
        o["dilate3"] = F.dilate_u8(g, 3)
        for op in ("open", "close", "gradient", "tophat", "blackhat"):
            o[f"morph_{op}"] = F.morphology_ex_u8(g, op, 3)
        o["thresh_bin"] = F.threshold_u8(g, jnp.uint8(117), jnp.uint8(255))
        o["thresh_trunc"] = F.threshold_u8(g, jnp.uint8(117), jnp.uint8(255),
                                           "trunc")
        o["adaptive"] = F.adaptive_threshold_u8(g)
        o["bilateral5"] = F.bilateral5_u8(g)
        o["canny"] = F.canny_u8(g)
        o["integral"] = F.integral_u8(g[0])
        o["pyr_down"] = F.pyr_down(g, has_channels=False)
        o["pyr_up"] = F.pyr_up(g, has_channels=False)
        o["equalize"] = HI.equalize_hist(g[0])
        o["calc_hist"] = HI.calc_hist(g[0])
        o["lut"] = HI.apply_lut(g, lut)
        o["harris_i32"] = FE.harris_response_i32(g[0])
        # arith family
        o["add"] = A.add_u8(g, g2)
        o["sub"] = A.subtract_u8(g, g2)
        o["absdiff"] = A.absdiff_u8(g, g2)
        o["addw"] = A.add_weighted_u8(g, 0.3, g2, 0.7, 5.0)
        o["csa"] = A.convert_scale_abs_u8(g, 1.5, -20.0)
        o["band"] = A.bitwise_and(g, g2)
        o["bor"] = A.bitwise_or(g, g2)
        o["bxor"] = A.bitwise_xor(g, g2)
        o["bnot"] = A.bitwise_not(g)
        o["norm_l2"] = A.norm_u8(g, "l2")
        o["cnz"] = A.count_non_zero(g)
        return o

    out.update(prog_filters(ins["gray"], ins["gray2"], ins["lut"]))

    @jax.jit
    def prog_color(yuyv, nv12, hwc, bgrp):
        o = {}
        o["yuyv_bgr"] = C.yuyv_to_bgr_packed(yuyv, W, H)
        o["yuyv_gray"] = C.yuyv_to_gray(yuyv, W, H)
        o["uyvy_bgr"] = C.uyvy_to_bgr_packed(yuyv, W, H)
        o["nv12_bgr"] = C.nv12_to_bgr_packed(nv12, W, H)
        o["nv12_gray"] = C.nv12_to_gray(nv12, W, H)
        o["yv12_bgr"] = C.yv12_to_bgr_packed(nv12, W, H)
        o["bayer"] = C.demosaic_bilinear_packed(
            nv12[:, : H * W].reshape(N, H, W), "RGGB", W, H)
        o["hsv"] = C.bgr_to_hsv(hwc)
        o["hsv_back"] = C.hsv_to_bgr(C.bgr_to_hsv(hwc))
        o["ycrcb"] = C.bgr_to_ycrcb(hwc)
        o["ycrcb_back"] = C.ycrcb_to_bgr(C.bgr_to_ycrcb(hwc))
        o["lab"] = C.bgr_to_lab(hwc)
        o["gray_from_bgr"] = C.bgr_to_gray(hwc)
        o["gray_packed"] = C.bgr_to_gray_packed_rows(bgrp, W, H)
        return o

    out.update(prog_color(ins["yuyv"], ins["nv12"], ins["hwc"], ins["bgrp"]))

    @jax.jit
    def prog_geom(hwc, g, mapx, mapy):
        o = {}
        o["resize_bl"] = R.resize_bilinear(hwc, 320, 200)
        o["resize_nn"] = R.resize_nearest(hwc, 333, 190)
        o["resize_area"] = R.resize_area(hwc, 256, 144)
        o["resize_cubic"] = R.resize_bicubic(hwc, 320, 200)
        m = np.array([[0.96, -0.27, 14.0], [0.27, 0.96, -9.0]], np.float64)
        o["warp_affine"] = WP.warp_affine(hwc, m, (W, H))
        hm = WP.get_perspective_transform(
            np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]], np.float64),
            np.array([[12, 7], [W - 9, 3], [W - 2, H - 11], [4, H - 6]], np.float64),
        )
        o["warp_persp"] = WP.warp_perspective(hwc, hm, (W, H))
        o["remap"] = WP.remap(g[0], mapx, mapy)
        o["warp_polar"] = WP.warp_polar(g[0], (W / 2, H / 2), 200.0, (H, W))
        return o

    out.update(prog_geom(ins["hwc"], ins["gray"], ins["mapx"], ins["mapy"]))

    # Every remaining device twin in ops/. Heavier iterative kernels run on
    # a smaller crop to bound compile and run time.
    from rustcv_tpu.ops import bgsub as BG
    from rustcv_tpu.ops import blend as BL
    from rustcv_tpu.ops import corner as CO
    from rustcv_tpu.ops import draw as DR
    from rustcv_tpu.ops import dtfilter as DT
    from rustcv_tpu.ops import fast as FA
    from rustcv_tpu.ops import hough as HO
    from rustcv_tpu.ops import hist as HI2
    from rustcv_tpu.ops import inpaint as IP
    from rustcv_tpu.ops import jpeg_tpu as JT
    from rustcv_tpu.ops import knn_bgsub as KN
    from rustcv_tpu.ops import kmeans as KM
    from rustcv_tpu.ops import morphx as MX
    from rustcv_tpu.ops import nlmeans as NL
    from rustcv_tpu.ops import meanshift_filter as MS
    from rustcv_tpu.ops import optflow as OF
    from rustcv_tpu.ops import farneback as FB
    from rustcv_tpu.ops import registration as RG
    from rustcv_tpu.ops import slic as SL
    from rustcv_tpu.ops import stereo as ST
    from rustcv_tpu.ops import sgbm as SG
    from rustcv_tpu.ops import template as TM
    from rustcv_tpu.ops import transform as TR
    from rustcv_tpu.ops import tvl1 as TV
    from rustcv_tpu.ops import watershed as WS

    g0 = ins["gray"][0]
    g1 = ins["gray2"][0]
    small = g0[:144, :256]
    small2 = g1[:144, :256]
    hwc_s = ins["hwc"][:144, :256]

    @jax.jit
    def prog_extra1(g, g2, hwc, sm, sm2):
        o = {}
        o["clahe"] = HI2.clahe(g)
        o["match_tmpl_ccoeffn"] = TM.match_template(
            g, g2[:24, :32], "ccoeff_normed")
        o["match_tmpl_sqdiff"] = TM.match_template(
            g, g2[:24, :32], "sqdiff")
        gx, gy = CO.spatial_gradient(g)
        o["spatial_gx"], o["spatial_gy"] = gx, gy
        o["corner_min_eig"] = CO.corner_min_eigen_val(g)
        o["corner_eig_vv"] = CO.corner_eigen_vals_and_vecs(g)
        o["pre_corner"] = CO.pre_corner_detect(g)
        o["fast_resp"] = FA.fast_response(g)
        o["harris_f32"] = FE.harris_response(g)
        o["dct"] = TR.dct(g.astype(jnp.float32))
        o["idct"] = TR.idct(TR.dct(g.astype(jnp.float32)))
        # FFT family via the matmul-plane forms (dft2_planes), the form
        # the device trackers use.
        f1p = TR.dft2_planes(g.astype(jnp.float32))
        f2p = TR.dft2_planes(g2.astype(jnp.float32))
        o["dft_re"], o["dft_im"] = f1p
        ms_re, ms_im = TR.mul_spectrums_planes(f1p, f2p, conj_b=True)
        o["mul_spec_re"], o["mul_spec_im"] = ms_re, ms_im
        shiftv, resp = RG.phase_correlate_matmul(g, g2)
        o["phase_corr_shift"], o["phase_corr_resp"] = shiftv, resp
        o["thinning"] = MX.thinning(g > 128)
        o["dtfilter"] = DT.dt_filter(hwc, hwc)
        o["multiband"] = BL.multi_band_blend(hwc, hwc[::-1],
                                             (g > 128)[: hwc.shape[0]])
        o["inpaint_diff"] = IP.inpaint_diffusion(
            sm, (sm2 > 200), max_iters=64)
        o["tvl1"] = TV.denoise_tvl1(
            jnp.stack([sm, sm2, sm]), niters=8)
        return o

    out.update(prog_extra1(g0, g1, ins["hwc"], small, small2))

    @jax.jit
    def prog_extra2(sm, sm2, hwc_small):
        o = {}
        o["nlm"] = NL.nl_means(sm, 10.0, 7, 11)
        o["nlm_color"] = NL.nl_means_colored(hwc_small, 3.0, 3.0, 7, 11)
        o["meanshift"] = MS.pyr_mean_shift(hwc_small, 5, 20.0, 1, 3)
        o["slic_labels"] = SL.slic_device(hwc_small, 24, 10.0, 4)
        d_bm, v_bm = ST.stereo_bm(sm, sm2, 32, 9)
        o["stereo_bm_disp"], o["stereo_bm_valid"] = d_bm, v_bm
        o["sgbm_disp"] = SG.stereo_sgbm(sm, sm2, 32, 5)[0]
        o["watershed"] = WS._flood(
            sm, jnp.where(sm > 200, 1, jnp.where(sm < 50, 2, 0)
                          ).astype(jnp.int32), 64)[0]
        o["farneback"] = FB.farneback_flow(sm, sm2, 2, 9, 2)
        pts = jnp.asarray([[30.0, 40.0], [120.0, 60.0], [200.0, 100.0]],
                          jnp.float32)
        np_, st_ = OF.calc_optical_flow_pyr_lk(sm, sm2, pts, 15, 2, 5)
        o["lk_pts"], o["lk_status"] = np_, st_
        return o

    out.update(prog_extra2(small, small2, hwc_s))

    # Remaining jax device twins (the OPS.md row diff).
    from rustcv_tpu.ops import akaze as AK
    from rustcv_tpu.ops import disflow as DI
    from rustcv_tpu.ops import hdr as HD
    from rustcv_tpu.ops import hog as HG
    from rustcv_tpu.ops import kalman as KA
    from rustcv_tpu.ops import sift as SI

    @jax.jit
    def prog_extra3(sm, sm2, hwc_small, stack):
        o = {}
        o["mertens"] = HD.merge_mertens(stack)
        o["detail_enhance"] = DT.detail_enhance(hwc_small)
        o["stylization"] = DT.stylization(hwc_small)
        pg, pc = DT.pencil_sketch(hwc_small)
        o["pencil_gray"], o["pencil_color"] = pg, pc
        o["aniso_diff"] = MX.anisotropic_diffusion(sm)
        o["guided"] = DT.guided_filter(sm, hwc_small)
        o["disflow"] = DI.dis_flow(sm, sm2)
        circ, cvotes, cvalid = HO.hough_circles(sm)
        o["hough_circ"], o["hough_circ_votes"] = circ, cvotes
        o["hough_circ_valid"] = cvalid
        x0 = jnp.zeros((2, 4))
        p0 = jnp.tile(jnp.eye(4), (2, 1, 1))
        zs = (sm[:10, :4].astype(jnp.float32) / 255.0).reshape(10, 1, 4)[
            :, :, :2].repeat(2, axis=1)
        a4 = jnp.eye(4)
        h24 = jnp.asarray(np.eye(2, 4), jnp.float32)
        xs_k, xf_k, pf_k = KA.filter_scan(
            x0, p0, zs, a4, h24, jnp.eye(4) * 0.01, jnp.eye(2) * 0.1)
        o["kalman_xs"], o["kalman_pf"] = xs_k, pf_k
        sw = jnp.asarray(
            np.random.default_rng(7).standard_normal(3780), jnp.float32)
        o["hog_score"] = HG.hog_score_map(sm, sw, jnp.float32(-1.0))
        return o

    stack3 = jnp.stack([ins["hwc"][:144, :256],
                        (ins["hwc"][:144, :256] // 2),
                        jnp.minimum(ins["hwc"][:144, :256] * 2, 255)])
    out.update(prog_extra3(small, small2, hwc_s, stack3))

    # sift / akaze pyramid builders: host-orchestrated (they stage per-
    # octave jits internally) — called eagerly, first-octave plane kept
    gos = SI.build_pyramids_device(np.asarray(small))
    out["sift_gauss0"] = jnp.asarray(np.asarray(gos[0][0] if isinstance(
        gos, tuple) else gos[0], np.float32))
    aks = AK.build_scale_space_device(
        np.asarray(small).astype(np.float32) / 255.0, 2, 2)
    out["akaze_ss0"] = jnp.asarray(np.asarray(
        aks[0][0] if isinstance(aks, tuple) else aks[0], np.float32))

    # stateful / multi-output twins (own jits inside)
    st0 = BG.mog2_init(g0.shape)
    st1, fg = jax.jit(BG.mog2_step)(st0, g0)
    _, fg2 = jax.jit(BG.mog2_step)(st1, g1)
    out["mog2_fg"] = fg2
    out["mog2_shadow"] = jax.jit(BG.shadow_mask)(st1, g1, fg2)
    ks = KN.knn_init(g0)
    ks1, kfg = jax.jit(KN.knn_step)(ks, g0)
    _, kfg2 = jax.jit(KN.knn_step)(ks1, g1)
    out["knn_fg"] = kfg2
    data = np.asarray(ins["hwc"], np.float32).reshape(-1, 3)[:4096]
    c0 = KM.kmeans_pp_init(data, 6)
    cen_km, lab_km, _inertia = KM.kmeans(jnp.asarray(data), 6,
                                         init_centers=jnp.asarray(c0))
    out["kmeans_labels"] = lab_km
    out["kmeans_centers"] = cen_km
    lines_l, valid_l, votes_l = HO.hough_lines(
        (g0 > 200).astype(jnp.uint8) * 255, threshold=40)
    out["hough_votes"] = votes_l
    out["hough_valid"] = valid_l
    rect1 = DR.rectangle(jnp.asarray(ins["hwc"]),
                         jnp.asarray([40, 30, 200, 120], jnp.int32),
                         jnp.asarray([0, 255, 0], jnp.uint8),
                         jnp.int32(2))
    out["draw_rect"] = rect1
    qt = jnp.asarray(np.full((8, 8), 16, np.int32))
    coeffs = jnp.asarray(
        (np.asarray(ins["gray"][0][:64, :64]).astype(np.int16) - 100)
        .reshape(8, 8, 8, 8).swapaxes(1, 2))  # (bh, bw, 8, 8)
    out["jpeg_idct"] = JT.dequant_idct_plane(coeffs, qt)
    out["jpeg_up_h2v2"] = JT.upsample(
        jnp.asarray(ins["gray"][0][:64, :64]), 2, 2)

    res = {}
    bad = []
    for k, v in out.items():
        try:
            res[k] = np.asarray(v)
        except Exception as e:  # name the op that hit a backend error
            print(f"FETCH-FAIL {k}: {type(e).__name__} {str(e)[:200]}",
                  flush=True)
            bad.append(k)
    if bad:
        raise RuntimeError(f"backend failed fetching: {bad}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description="GPU vs CPU parity sweep")
    ap.add_argument("--out", default="parity.json", help="JSON result path")
    ap.add_argument("--cpu-ref", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_ref:
        np.savez_compressed(args.cpu_ref, **compute_all())
        print("CPU reference written")
        return

    here = os.path.dirname(os.path.abspath(__file__))
    out_path = os.path.abspath(args.out)
    ref_npz = os.path.splitext(out_path)[0] + "_cpu_ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--cpu-ref", ref_npz],
                   check=True, cwd=here, env=env)
    ref = np.load(ref_npz)

    from rustcv_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"probe_parity.py needs a GPU; JAX platform is "
                         f"{jax.default_backend()!r}")
    got = compute_all()
    # Documented-tolerance ops (their own docstrings): float-math kernels
    # where XLA's FMA/excess-precision fusion differs between the CPU and
    # GPU backends by ≤1 LSB — add_weighted_u8 ("±1 LSB ... for non-dyadic
    # weights", ops/arith.py) and bgr_to_lab (f32 cube-root path). Scalar
    # float reductions compare with rtol instead of bitwise.
    TOL_1LSB = {"addw", "lab",
                # f32-internal u8 kernels where fma and reciprocal
                # rounding can flip a knife edge
                "nlm", "nlm_color", "dtfilter", "multiband",
                "inpaint_diff", "tvl1", "jpeg_up_h2v2"}
    # decision kernels (per-pixel argmin / threshold on f32): a flipped
    # tie changes the LABEL, not a value — contract is distributional
    FRAC_TOL = {"mog2_fg": 0.01, "knn_fg": 0.01, "mog2_shadow": 0.01,
                # compound op: the device Lab conversion's documented
                # +-1 LSB (f32 cube root) perturbs the nl-means patch
                # distances, and at h_color=3 the exp weights amplify a
                # 1-LSB input change into multi-LSB output moves on flat
                # regions; gray nl_means isolates the filter arithmetic
                # at +-1
                "nlm_color": 0.50,
                "slic_labels": 0.01, "watershed": 0.02,
                "kmeans_labels": 0.02, "meanshift": 0.02,
                "hough_votes": 0.05, "hough_valid": 0.20,
                "lk_status": 0.34, "stereo_bm_valid": 0.01,
                "stereo_bm_disp": 0.01, "sgbm_disp": 0.01}
    # iterative float solvers: compare loosely (documented)
    FLOAT_LOOSE = {"farneback": 0.05, "lk_pts": 0.5,
                   # f32 basis-matmul spectra: cross-backend FMA ordering
                   # scales with |value| (DC bin O(4e7); products O(1e15);
                   # DCT DC O(1e5))
                   "dft_re": 1.0, "dft_im": 1.0,
                   "mul_spec_re": 1e6, "mul_spec_im": 1e6,
                   "dct": 2.0, "idct": 0.1,
                   # eigenVECTORS are ill-conditioned where l1~l2 (the
                   # direction is arbitrary in the isotropic limit)
                   "corner_eig_vv": 0.02,
                   "phase_corr_shift": 0.05, "phase_corr_resp": 0.02,
                   "kmeans_centers": 0.5}
    results, failed = {}, []
    for k in ref.files:
        a, b = ref[k], got[k]
        if a.shape != b.shape:
            results[k] = f"SHAPE {a.shape} vs {b.shape}"
            failed.append(k)
        elif np.issubdtype(a.dtype, np.floating):
            atol = FLOAT_LOOSE.get(k, 1e-5)
            rtol = 1e-3 if k in FLOAT_LOOSE else 1e-5
            if np.allclose(a, b, rtol=rtol, atol=atol):
                results[k] = (f"float_close(atol={atol})"
                              if k in FLOAT_LOOSE
                              else "float_close(rtol=1e-5)")
            elif k in FRAC_TOL and np.isfinite(a).all():
                frac = float((np.abs(a - b) > 1.0).mean())
                if frac <= FRAC_TOL[k]:
                    results[k] = f"frac_ok({frac:.4f}<=~{FRAC_TOL[k]})"
                else:
                    results[k] = f"MISMATCH float frac={frac:.4f}"
                    failed.append(k)
            else:
                results[k] = f"MISMATCH float max={float(np.abs(a - b).max())}"
                failed.append(k)
        elif np.array_equal(a, b):
            results[k] = "exact"
        else:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64))
            frac = float((d > 0).mean())
            if k in TOL_1LSB and d.max() <= 1:
                results[k] = (
                    f"tol_ok(max=1, frac={frac:.4f}) — "
                    "documented f32-fma tolerance")
            elif k in FRAC_TOL and frac <= FRAC_TOL[k]:
                results[k] = (
                    f"frac_ok(frac={frac:.4f}<={FRAC_TOL[k]}) — "
                    "documented decision-flip tolerance")
            else:
                results[k] = (
                    f"MISMATCH max={int(d.max())} "
                    f"frac={frac:.4f}")
                failed.append(k)
    rec = {
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "shape": f"{N}x{H}x{W}",
        "ops": results,
        "n_ops": len(results),
        "n_exact": sum(1 for v in results.values() if v == "exact"),
        "n_tol": sum(1 for v in results.values()
                     if v.startswith(("tol_ok", "float_close"))),
        "failed": failed,
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    print(json.dumps({"n_ops": rec["n_ops"], "n_exact": rec["n_exact"],
                      "failed": failed}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
