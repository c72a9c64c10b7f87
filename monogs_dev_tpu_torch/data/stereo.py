"""Semi-global block matching on the device: the disparity that the JAX
package's `StereoDataset` takes from `cv2.StereoSGBM_create(minDisparity=0,
numDisparities=64, blockSize=20)` with `setUniquenessRatio(40)`
(`monogs_dev_tpu/data/datasets.py:311-313`), in plain torch.

The matcher follows cv2's documented semi-global matching in its default
five-path mode, with the effective parameters that cv2 substitutes for the
ones the loader leaves at 0 (read off cv2's output on hand-made and
rendered pairs, `tests/test_torch_datasets.py`):

  - the pixel cost is the Birchfield-Tomasi sampling-insensitive distance
    on two channels: the horizontal Sobel response clipped to +-15
    (pre-filter cap 15) and the raw intensity, the latter divided by 4;
  - the matching cost is the pixel cost summed over a (2*10+1)^2 block
    (blockSize 20 -> half-width 10), borders replicated;
  - five aggregation paths (left, top-left, top, top-right, right), each
    L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1,
    min_k L(p-r, k) + P2) - min_k L(p-r, k), with P1 = 2 and P2 = 5, and 0
    outside the image (cv2 stores C + P2 and subtracts min_k L + P2, which
    is the same);
  - the five paths summed and saturated at 32767, as cv2 keeps the sum in
    int16 (every L is >= C >= 0, so one clamp of the whole sum equals
    cv2's saturating adds);
  - winner takes all over the summed paths, rejected unless every
    disparity more than 1 away costs at least 100/(100-40) times the best;
  - a parabola through the best cost and its neighbours for 1/16 pixel;
  - a left-right check: the disparity is kept when it agrees within 1
    with the right image's winner at either of its two integer roundings;
  - a 3x3 median over the whole fixed-point image (`median3x3`), as
    `StereoSGBM::compute` runs `medianBlur(disp, disp, 3)` after the
    matcher: invalid pixels and the first NUM_DISP columns take part,
    borders replicated.

Disparities are fixed point x16; invalid ones, and the first NUM_DISP
columns, are -16. Everything is integer arithmetic, so the result does not
depend on the device.

On the EuRoC writer's pairs the result equals cv2's on every pixel at every
uniqueness ratio from 0 to 80 (tests/test_torch_datasets.py). cv2 keeps
the block costs and the paths in int16 too, where a block cost over 32767
would wrap; only the sum's saturation is modelled, as block costs stay far
below that on images (at most ~19,500 on those pairs; the ceiling is
93 x 21^2).
"""

from __future__ import annotations

import torch

NUM_DISP = 64
BLOCK_SIZE = 20
UNIQUENESS_RATIO = 40
P1, P2 = 2, 5
PREFILTER_CAP = 15
DISP12_MAX_DIFF = 1
DISP_SCALE = 16
COST_MAX = 32767  # cv2's costs are int16
INVALID = -DISP_SCALE  # (minDisparity - 1) * 16


def _channels(img: torch.Tensor) -> torch.Tensor:
    """(2, H, W) int32: the clipped x-Sobel (offset to [0, 30]) and the raw
    intensity; both are 15 in the first and last column."""
    h, w = img.shape
    up = torch.cat([img[:1], img[:-1]])
    down = torch.cat([img[1:], img[-1:]])
    dx = lambda a: a[:, 2:] - a[:, :-2]  # noqa: E731
    sob = 2 * dx(img) + dx(up) + dx(down)
    sob = torch.clamp(sob, -PREFILTER_CAP, PREFILTER_CAP) + PREFILTER_CAP
    out = torch.full((2, h, w), PREFILTER_CAP, dtype=torch.int32, device=img.device)
    out[0, :, 1:-1] = sob
    out[1, :, 1:-1] = img[:, 1:-1]
    return out


def _half_range(ch: torch.Tensor):
    """Per pixel, the min and max of the pixel and its two half-way
    neighbours ((v + v[x+-1]) // 2; the pixel itself at a border)."""
    left = torch.cat([ch[..., :1], (ch[..., 1:] + ch[..., :-1]) // 2], dim=-1)
    right = torch.cat([(ch[..., :-1] + ch[..., 1:]) // 2, ch[..., -1:]], dim=-1)
    return (torch.minimum(torch.minimum(left, right), ch),
            torch.maximum(torch.maximum(left, right), ch))


def pixel_costs(left: torch.Tensor, right: torch.Tensor):
    """(H, W - NUM_DISP, NUM_DISP) int32 Birchfield-Tomasi costs of left
    pixel x in [NUM_DISP, W) against right pixel x - d."""
    h, w = left.shape
    dev = left.device
    u, v = _channels(left), _channels(right)
    u0, u1 = _half_range(u)
    v0, v1 = _half_range(v)
    xs = torch.arange(NUM_DISP, w, device=dev)
    xr = xs[:, None] - torch.arange(NUM_DISP, device=dev)[None, :]  # (W1, D)
    cost = torch.zeros((h, w - NUM_DISP, NUM_DISP), dtype=torch.int32, device=dev)
    for c, shift in ((0, 0), (1, 2)):
        uc = u[c][:, xs, None]
        uc0, uc1 = u0[c][:, xs, None], u1[c][:, xs, None]
        vc, vc0, vc1 = v[c][:, xr], v0[c][:, xr], v1[c][:, xr]
        c0 = torch.clamp(torch.maximum(uc - vc1, vc0 - uc), min=0)
        c1 = torch.clamp(torch.maximum(vc - uc1, uc0 - vc), min=0)
        cost += torch.minimum(c0, c1) >> shift
    return cost


def _box_sum(x: torch.Tensor, dim: int, half: int) -> torch.Tensor:
    """Sum over a window of 2*half+1 along `dim`, borders replicated."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-half, n + half, device=x.device), 0, n - 1)
    xp = x.index_select(dim, idx)
    cs = torch.cumsum(xp, dim=dim)
    zero = torch.zeros_like(cs.narrow(dim, 0, 1))
    cs = torch.cat([zero, cs], dim=dim)
    return cs.narrow(dim, 2 * half + 1, n) - cs.narrow(dim, 0, n)


def block_costs(cost: torch.Tensor) -> torch.Tensor:
    half = BLOCK_SIZE // 2
    return _box_sum(_box_sum(cost, 1, half), 0, half)


def _step(c: torch.Tensor, prev: torch.Tensor, prev_min: torch.Tensor) -> torch.Tensor:
    """One path step: c, prev (..., D), prev_min (..., 1)."""
    big = torch.full_like(prev[..., :1], 1 << 28)
    lo = torch.cat([big, prev[..., :-1]], dim=-1) + P1
    hi = torch.cat([prev[..., 1:], big], dim=-1) + P1
    jump = prev_min + P2
    return c + torch.minimum(torch.minimum(prev, jump), torch.minimum(lo, hi)) - prev_min


def aggregate(c: torch.Tensor) -> torch.Tensor:
    """(H, W1, D) block costs -> the sum of the five path costs, saturated
    at COST_MAX."""
    h, w1, d = c.shape
    total = torch.zeros_like(c)
    # left-to-right and right-to-left, every row at once
    for xs in (range(w1), range(w1 - 1, -1, -1)):
        prev = torch.zeros((h, d), dtype=c.dtype, device=c.device)
        prev_min = torch.zeros((h, 1), dtype=c.dtype, device=c.device)
        for x in xs:
            cur = _step(c[:, x], prev, prev_min)
            total[:, x] += cur
            prev, prev_min = cur, cur.amin(dim=-1, keepdim=True)
    # top-left, top and top-right, row by row, every column at once
    zero = torch.zeros((1, 1, d), dtype=c.dtype, device=c.device)
    prev = torch.zeros((3, w1, d), dtype=c.dtype, device=c.device)
    for y in range(h):
        shifted = torch.stack([torch.cat([zero[0], prev[0, :-1]]), prev[1],
                               torch.cat([prev[2, 1:], zero[0]])])
        cur = _step(c[y][None], shifted, shifted.amin(dim=-1, keepdim=True))
        total[y] += cur.sum(dim=0)
        prev = cur
    return torch.clamp(total, max=COST_MAX)


def median3x3(disp: torch.Tensor) -> torch.Tensor:
    """cv2.medianBlur(disp, 3) of an integer (H, W) image: the middle of
    each pixel's 3x3 neighbourhood, borders replicated."""
    h, w = disp.shape
    ys = torch.clamp(torch.arange(-1, h + 1, device=disp.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-1, w + 1, device=disp.device), 0, w - 1)
    pad = disp[ys][:, xs]
    nine = torch.stack([pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
    return torch.sort(nine, dim=0).values[4]


def sgbm_disparity(left: torch.Tensor, right: torch.Tensor,
                   uniqueness_ratio: int = UNIQUENESS_RATIO) -> torch.Tensor:
    """(H, W) uint8 rectified pair -> (H, W) int32 disparity x16 of the left
    image, INVALID where no match was accepted, after cv2's 3x3 median."""
    left = left.to(torch.int32)
    right = right.to(torch.int32)
    h, w = left.shape
    dev = left.device
    s = aggregate(block_costs(pixel_costs(left, right)))
    min_s, best = s.min(dim=-1)  # the first minimum, as cv2's strict `<`
    ds = torch.arange(NUM_DISP, device=dev)
    far = (ds[None, None, :] - best[..., None]).abs() > 1
    unique = ~((s * (100 - uniqueness_ratio) < min_s[..., None] * 100) & far).any(dim=-1)

    # sub-pixel: a parabola through the neighbours, C's truncating division
    sm = torch.gather(s, 2, torch.clamp(best - 1, 0, NUM_DISP - 1)[..., None])[..., 0]
    sp = torch.gather(s, 2, torch.clamp(best + 1, 0, NUM_DISP - 1)[..., None])[..., 0]
    denom2 = torch.clamp(sm + sp - 2 * min_s, min=1)
    frac = torch.div((sm - sp) * DISP_SCALE + denom2, denom2 * 2, rounding_mode="trunc")
    inner = (best > 0) & (best < NUM_DISP - 1)
    disp1 = torch.where(inner, best * DISP_SCALE + frac, best * DISP_SCALE)

    # the right image's winners: per right pixel, the accepted left pixel of
    # least cost (ties: the rightmost, as cv2 walks right to left)
    xs = torch.arange(NUM_DISP, w, device=dev)
    x2 = (xs[None, :] - best).to(torch.int64)
    key = min_s.to(torch.int64) * w + (w - 1 - xs[None, :])
    big = torch.iinfo(torch.int64).max
    key = torch.where(unique, key, torch.full_like(key, big))
    win = torch.full((h, w), big, dtype=torch.int64, device=dev)
    win.scatter_reduce_(1, x2, key, reduce="amin")
    has = win != big
    disp2 = torch.where(has, w - 1 - (win % w), torch.zeros_like(win))  # left x
    disp2 = torch.where(has, disp2 - torch.arange(w, device=dev)[None, :], -1)  # its d

    d1 = torch.where(unique, disp1, torch.full_like(disp1, INVALID))
    lo = d1 >> 4
    hi = (d1 + DISP_SCALE - 1) >> 4

    def inconsistent(dd):
        xx = xs[None, :] - dd
        ok = (xx >= 0) & (xx < w)
        d2 = torch.gather(disp2, 1, torch.clamp(xx, 0, w - 1).to(torch.int64))
        return ok & (d2 >= 0) & ((d2 - dd).abs() > DISP12_MAX_DIFF)

    reject = inconsistent(lo) & inconsistent(hi)
    d1 = torch.where(unique & ~reject, d1, torch.full_like(d1, INVALID))
    out = torch.full((h, w), INVALID, dtype=torch.int32, device=dev)
    out[:, NUM_DISP:] = d1.to(torch.int32)
    return median3x3(out)
