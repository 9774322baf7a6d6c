"""Two-view relative-pose initialization: H/F-model RANSAC, in torch.

Port of ``orb_slam2_tpu/geom/twoview.py`` (upstream ORB-SLAM2's
monocular initializer, src/Initializer.cc, which the reference fork
replaced with known-pose triangulation).  Fixed-batch RANSAC: all
hypotheses solved by one batched SVD, all hypothesis x match scores as a
dense masked matrix, winners by argmax; the 4 (E) / 8 (H) motion
candidates are ranked by a batched cheirality check.

Semantics follow upstream Initializer.cc:
- normalized 8-point F and 4-point H DLT,
- symmetric transfer scoring with chi2 gates 5.991 (H) / 3.841 (F) and
  score offset 5.991,
- model selection by RH = SH / (SH + SF) > 0.40,
- ReconstructF: E = K^T F K, 4 (R, t) candidates,
- ReconstructH: Faugeras SVD decomposition, 8 candidates,
- CheckRT: triangulation, positive depth in both views, parallax,
  reprojection gates, winner uniqueness (second < 0.75 * best).

The SVDs' singular vectors are sign-ambiguous on cuSOLVER as on LAPACK:
a flipped pair of vectors reorders the motion candidates but leaves the
candidate set, and so the chosen motion, unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_OFFSET = 5.991


class TwoViewResult(NamedTuple):
    ok: torch.Tensor              # () bool
    R: torch.Tensor               # (3, 3) rotation cam1 -> cam2
    t: torch.Tensor               # (3,) unit-norm translation
    points: torch.Tensor          # (N, 3) triangulated in the cam-1 frame
    good: torch.Tensor            # (N,) bool triangulation inliers
    used_homography: torch.Tensor  # () bool


def _inv(A):
    """Batched inverse without the error check (no host read)."""
    return torch.linalg.inv_ex(A, check_errors=False).inverse


def _normalize(uv, valid):
    """Initializer::Normalize: zero mean, unit mean absolute deviation."""
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    md = ((uv - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (uv - mean) * s, T


def _hom(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


# ----------------------------------------------------------------------
# minimal solvers, batched over hypotheses
# ----------------------------------------------------------------------
def _solve_h_batch(p1, p2):
    """4-point homography DLT: p1, p2 (B, 4, 2) -> (B, 3, 3) with
    x2 ~ H x1 (Initializer::ComputeH21)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    A = torch.cat([r1, r2], dim=-2)                 # (B, 8, 9)
    Vt = torch.linalg.svd(A, full_matrices=True).Vh
    return Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def _solve_f_batch(p1, p2):
    """8-point fundamental: (B, 8, 2) x2 -> (B, 3, 3) with x2^T F x1 = 0
    (Initializer::ComputeF21), rank 2 enforced."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], -1)
    Vt = torch.linalg.svd(A, full_matrices=True).Vh
    F = Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., None] * Vt2)


# ----------------------------------------------------------------------
# model scoring (CheckHomography / CheckFundamental)
# ----------------------------------------------------------------------
def _score(c_a, c_b, valid, chi2):
    ok = valid[None] & (c_a < chi2) & (c_b < chi2)
    zero = torch.zeros_like(c_a)
    score = torch.where(valid[None] & (c_a < chi2), SCORE_OFFSET - c_a,
                        zero).sum(-1) \
        + torch.where(valid[None] & (c_b < chi2), SCORE_OFFSET - c_b,
                      zero).sum(-1)
    return score, ok


def _score_h_batch(Hs, uv1, uv2, valid, inv_sigma2):
    """(B, 3, 3) x (N, 2) -> scores (B,), inlier masks (B, N)."""
    x1 = _hom(uv1)
    x2 = _hom(uv2)

    def transfer(H, src, dst):
        p = torch.einsum("bij,nj->bni", H, src)
        w = torch.where(p[..., 2:3].abs() < 1e-12,
                        torch.full_like(p[..., 2:3], 1e-12), p[..., 2:3])
        d = p[..., :2] / w - dst[None, :, :2]
        return (d * d).sum(-1) * inv_sigma2

    c21 = transfer(Hs, x1, x2)        # project 1 -> 2
    c12 = transfer(_inv(Hs), x2, x1)
    score, ok = _score(c21, c12, valid, CHI2_H)
    return score, ok


def _score_f_batch(Fs, uv1, uv2, valid, inv_sigma2):
    x1 = _hom(uv1)
    x2 = _hom(uv2)
    l2 = torch.einsum("bij,nj->bni", Fs, x1)      # epiline in image 2
    l1 = torch.einsum("bji,nj->bni", Fs, x2)      # epiline in image 1
    num2 = (l2 * x2[None]).sum(-1)
    num1 = (l1 * x1[None]).sum(-1)
    d2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2,
                                   min=1e-12) * inv_sigma2
    d1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2,
                                   min=1e-12) * inv_sigma2
    # the score adds the image-2 term first, as the JAX module does
    score, ok = _score(d2, d1, valid, CHI2_F)
    return score, ok


# ----------------------------------------------------------------------
# CheckRT: triangulate + cheirality, batched over candidate motions
# ----------------------------------------------------------------------
def _triangulate_batch(R, t, K, uv1, uv2):
    """R (C, 3, 3), t (C, 3): DLT triangulation of all N matches under
    each candidate -> (C, N, 3) in the camera-1 frame."""
    P1 = torch.cat([K, torch.zeros_like(K[:, :1])], dim=1)          # (3, 4)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)                   # (C, 3, 4)
    C, N = R.shape[0], uv1.shape[0]
    rows1 = torch.stack([uv1[:, 0:1] * P1[2] - P1[0],
                         uv1[:, 1:2] * P1[2] - P1[1]], dim=1)       # (N, 2, 4)
    rows2 = torch.stack([
        uv2[None, :, 0:1] * P2[:, None, 2] - P2[:, None, 0],
        uv2[None, :, 1:2] * P2[:, None, 2] - P2[:, None, 1]], dim=2)
    A = torch.cat([rows1[None].expand(C, N, 2, 4), rows2], dim=2)   # (C,N,4,4)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    w = torch.where(X[..., 3:4].abs() < 1e-12,
                    torch.full_like(X[..., 3:4], 1e-12), X[..., 3:4])
    return X[..., :3] / w


def _check_rt_batch(R, t, K, uv1, uv2, valid, inv_sigma2,
                    reproj_chi2: float = 4.0):
    """Upstream Initializer::CheckRT over C candidates: returns (n_good
    (C,), good masks (C, N), parallax cos at the 50th-smallest parallax
    (C,), points (C, N, 3))."""
    X = _triangulate_batch(R, t, K, uv1, uv2)                       # (C,N,3)
    finite = torch.isfinite(X).all(-1)
    z1 = X[..., 2]
    o2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]             # (C, 3)
    X2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = X2[..., 2]

    # parallax between the rays from both camera centers
    n2 = X - o2[:, None, :]
    cosp = (X * n2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1),
        min=1e-12)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(P, uv):
        zz = torch.where(P[..., 2].abs() < 1e-12,
                         torch.full_like(P[..., 2], 1e-12), P[..., 2])
        du = fx * P[..., 0] / zz + cx - uv[None, :, 0]
        dv = fy * P[..., 1] / zz + cy - uv[None, :, 1]
        return (du * du + dv * dv) * inv_sigma2

    e1 = reproj_err(X, uv1)
    e2 = reproj_err(X2, uv2)
    good = (valid[None] & finite
            & ((z1 > 0) | (cosp >= 0.99998))
            & ((z2 > 0) | (cosp >= 0.99998))
            & (cosp < 0.99998)
            & (e1 < reproj_chi2) & (e2 < reproj_chi2))
    n_good = good.sum(-1)

    # parallax statistic: upstream takes the 50th-smallest parallax
    # among good points (Initializer.cc CheckRT tail): the min(50, n)-th
    # largest cos among them
    sorted_cos = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)),
                            dim=-1).values
    idx = torch.clamp(n_good - 1, min=0).clamp(max=49)
    par_cos = torch.gather(sorted_cos, -1, idx[:, None])[:, 0]
    return n_good, good, par_cos, X


# ----------------------------------------------------------------------
# motion recovery
# ----------------------------------------------------------------------
def _motions_from_F(F, K):
    """E = K^T F K -> 4 candidate (R, t) (Initializer::ReconstructF /
    DecomposeE)."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=F.dtype, device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    # proper rotations
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_H(H, K):
    """Faugeras SVD decomposition -> 8 candidate (R, t)
    (Initializer::ReconstructH, after Faugeras & Lustman 1988)."""
    A = _inv(K) @ H @ K
    U, S, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3),
                                  min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3),
                                  min=0.0))
    x1 = torch.stack([aux1, aux1, -aux1, -aux1])
    x3 = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))

    Rs, ts = [], []
    # case d' = d2 > 0
    den = torch.clamp((d1 + d3) * d2, min=1e-12)
    aux_s = root / den
    s_t = torch.stack([aux_s, -aux_s, -aux_s, aux_s])
    c_t = (d2 * d2 + d1 * d3) / den
    for i in range(4):
        Rp = torch.stack([torch.stack([c_t, zero, -s_t[i]]),
                          torch.stack([zero, one, zero]),
                          torch.stack([s_t[i], zero, c_t])])
        tp = torch.stack([x1[i], zero, -x3[i]]) * (d1 - d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    # case d' = -d2 < 0
    den = torch.clamp((d1 - d3) * d2, min=1e-12)
    aux_sp = root / den
    s_p = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    c_p = (d1 * d3 - d2 * d2) / den
    for i in range(4):
        Rp = torch.stack([torch.stack([c_p, zero, s_p[i]]),
                          torch.stack([zero, -one, zero]),
                          torch.stack([s_p[i], zero, -c_p])])
        tp = torch.stack([x1[i], zero, x3[i]]) * (d1 + d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return Rs, ts


# ----------------------------------------------------------------------
# full initializer
# ----------------------------------------------------------------------
def initialize_two_view(uv1: torch.Tensor, uv2: torch.Tensor,
                        valid: torch.Tensor, inv_sigma2: torch.Tensor,
                        K: torch.Tensor, samples8: torch.Tensor,
                        min_triangulated: int = 50,
                        min_parallax_deg: float = 1.0) -> TwoViewResult:
    """uv1, uv2 (N, 2) matched undistorted keypoints; valid (N,);
    inv_sigma2 (N,) of the frame-2 octaves; K (3, 3); samples8 (B, 8)
    RANSAC minimal samples (H uses the first 4 of each)."""
    samples8 = samples8.long()
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)

    # --- fit both models on the same sample batch ---
    Hn = _solve_h_batch(n1[samples8[:, :4]], n2[samples8[:, :4]])
    Fn = _solve_f_batch(n1[samples8], n2[samples8])
    Hs = _inv(T2) @ Hn @ T1          # denormalize: x2 = H x1
    Fs = T2.T @ Fn @ T1

    sample_ok = valid[samples8].all(-1)
    score_h, ok_h = _score_h_batch(Hs, uv1, uv2, valid, inv_sigma2)
    score_f, ok_f = _score_f_batch(Fs, uv1, uv2, valid, inv_sigma2)
    score_h = torch.where(sample_ok, score_h, torch.full_like(score_h, -1.0))
    score_f = torch.where(sample_ok, score_f, torch.full_like(score_f, -1.0))
    bh = torch.argmax(score_h)
    bf = torch.argmax(score_f)
    SH, SF = score_h[bh], score_f[bf]
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    def pick(Rc, tc, inliers):
        n_good, good, par_cos, X = _check_rt_batch(
            Rc, tc, K, uv1, uv2, valid & inliers, inv_sigma2)
        order = torch.argsort(-n_good, stable=True)
        best, second = order[0], order[1]
        n_best = n_good[best]
        distinct = n_good[second] < 0.75 * n_best
        n_inl = (valid & inliers).sum()
        enough = n_best > torch.clamp((0.9 * n_inl).long(),
                                      min=min_triangulated)
        par_deg = torch.rad2deg(torch.arccos(par_cos[best].clamp(-1, 1)))
        ok = distinct & enough & (par_deg > min_parallax_deg)
        return ok, Rc[best], tc[best], X[best], good[best]

    okH, RH_, tH_, XH_, gH_ = pick(*_motions_from_H(Hs[bh], K), ok_h[bh])
    okF, RF_, tF_, XF_, gF_ = pick(*_motions_from_F(Fs[bf], K), ok_f[bf])
    return TwoViewResult(
        ok=torch.where(use_h, okH, okF), R=torch.where(use_h, RH_, RF_),
        t=torch.where(use_h, tH_, tF_), points=torch.where(use_h, XH_, XF_),
        good=torch.where(use_h, gH_, gF_), used_homography=use_h)

