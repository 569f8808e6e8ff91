"""Whole-iteration and chained-iteration kernels (csrc/iteration.cu) and
their plain torch versions.

Replaces clover_tpu/kernels/iteration.py iteration_pallas and
iteration_chain_pallas.  For a 4-bit Phi with 4-bit (4x4) or 8-bit (4x8)
vectors, one launch computes the solver iteration

    t2 = Q(y - Q(Phi @ x))          leg A, seeds s[0] (MVM), s[1] (AXPY)
    x' = Q(x + mu * Q(PhiT @ t2))   leg B, seeds s[2], s[3]

and the chained kernel ``chain = len(seeds) // 4`` of them, iteration ``it``
taking seeds ``s[4 it : 4 it + 4]`` and ending in the exact top-``k``
threshold (GD when ``k`` is None).  ``noise`` holds the four per-op SR flags
that every iteration shares.  The kernels equal the unfused kernel
sequence (the fused MVM+AXPY twice, then the threshold) bit for bit, SR
included; the plain versions are that sequence through the MVM's and the
threshold's plain versions.  Operands are ``(codes, scales)`` pairs: Phi,
PhiT (its transpose), then y and x of the output class (4-bit for 4x4,
8-bit for 4x8); results are pairs too.

The kernels are cooperative launches: every CTA must be resident at once
for the grid barriers.  Both run in clusters of CHAIN_CLUSTER CTAs sharing
each band, so the grid is that many CTAs per band of the larger leg, capped
by the CTAs that fit on the card (computed once per device and kernel), in
whole clusters.  A grid that does not fit raises; nothing retries through
the unfused path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..formats import BLOCK, QMat4, QVec4, QVec8
from .. import tracing
from . import _build
from .mvm import mvm4_plain, mvm8_plain
from .threshold import threshold4_plain, threshold8_plain

MODES = ((4, 4), (4, 8))
MAX_CHAIN = 16           # csrc/iteration.cu MAX_CHAIN
CHAIN_CLUSTER = 2        # csrc/iteration.cu CHAIN_CLUSTER: CTAs a band
SIDE_STEP = 512          # eligible padded sides: multiples of this ...
SIDE_MAX = 8192          # ... up to this


def _mode(Phi, x) -> tuple[int, int] | None:
    if isinstance(Phi, QMat4) and isinstance(x, QVec4):
        return 4, 4
    if isinstance(Phi, QMat4) and isinstance(x, QVec8):
        return 4, 8
    return None


def iteration_eligible(Phi, PhiT, y, x) -> bool:
    """The solver takes the whole-iteration kernel: a 4x4 or 4x8 problem
    (never 8x8), PhiT Phi's transpose in class and padding, y and x of the
    output class with Phi's rows and columns as lengths, and both padded
    sides multiples of 512 up to 8192 (the rule of clover_tpu's
    iteration_pallas_eligible)."""
    mode = _mode(Phi, x)
    if mode is None:
        return False
    if not (isinstance(PhiT, type(Phi)) and PhiT.rows_pad == Phi.cols_pad
            and PhiT.cols_pad == Phi.rows_pad):
        return False
    out_cls = QVec4 if mode == (4, 4) else QVec8
    if not (isinstance(y, out_cls) and isinstance(x, out_cls)
            and y.length == Phi.rows and x.length == Phi.cols):
        return False
    return all(side % SIDE_STEP == 0 and side <= SIDE_MAX
               for side in (Phi.rows_pad, Phi.cols_pad))


def iteration_chain_eligible(Phi, PhiT, y, x, k) -> bool:
    """:func:`iteration_eligible`, and ``0 < k < Phi.cols`` or GD."""
    return (iteration_eligible(Phi, PhiT, y, x)
            and (k is None or 0 < int(k) < Phi.cols))


def _mvm(bits_a: int, bits_x: int):
    return mvm4_plain if bits_x == 4 else functools.partial(mvm8_plain, bits_a)


def iteration_plain(bits_a: int, bits_x: int, phi, phit, y, x, mu: float,
                    seeds=(0, 0, 0, 0), noise=(False,) * 4):
    """One iteration as the fused MVM+AXPY twice."""
    mvm = _mvm(bits_a, bits_x)
    t2 = mvm(*phi, *x, *y, -1.0, seeds[0], noise[0], seeds[1], noise[1])
    return mvm(*phit, *t2, *x, mu, seeds[2], noise[2], seeds[3], noise[3])


def iteration_chain_plain(bits_a: int, bits_x: int, phi, phit, y, x,
                          mu: float, k, seeds, noise=(False,) * 4):
    """``len(seeds) // 4`` iterations, each :func:`iteration_plain` then
    the threshold when ``k`` is given.  Padding codes are zero, so the
    8-bit threshold may rank over the padded length."""
    for it in range(len(seeds) // 4):
        x = iteration_plain(bits_a, bits_x, phi, phit, y, x, mu,
                            seeds[4 * it:4 * it + 4], noise)
        if k is not None:
            codes, scales = x
            codes = (threshold4_plain(codes, scales, k) if bits_x == 4 else
                     threshold8_plain(codes, scales, k, codes.shape[0]))
            x = codes, scales
    return x


@functools.cache
def co_resident(device_index: int, bits_a: int, bits_x: int,
                chained: bool) -> int:
    """CTAs of a kernel that fit on the card at once: its co-resident
    clusters x CHAIN_CLUSTER."""
    device = torch.device("cuda", device_index)
    ctas = ctypes.c_int(0)
    _build.call("clover_iteration_occupancy", device, bits_a, bits_x,
                int(chained), ctypes.addressof(ctas))
    return ctas.value


def launch_grid(device: torch.device, bits_a: int, bits_x: int,
                chained: bool, bands: int, grid: int | None = None) -> int:
    """The cooperative grid in CTAs: ``grid``, or a cluster of
    CHAIN_CLUSTER CTAs per band capped by what fits, in whole clusters;
    raise when it does not fit."""
    capacity = co_resident(device.index, bits_a, bits_x, chained)
    c = CHAIN_CLUSTER
    if grid is None:
        grid = min(bands * c, capacity // c * c)
    if grid % c:
        raise ValueError(f"grid {grid}: the iteration kernels run in whole "
                         f"clusters of {c} CTAs")
    if not 1 <= grid <= capacity:
        kind = "chained iteration" if chained else "iteration"
        raise RuntimeError(
            f"cooperative launch of {grid} CTAs of the {bits_a}x{bits_x} "
            f"{kind} kernel: {capacity} fit on {device} at once "
            f"(co-resident clusters x CTAs), and the grid barrier needs "
            f"every CTA resident")
    return grid


def _operands(bits_a, bits_x, phi, phit, y, x):
    """Check the operands; -> (m_pad, n_pad, device)."""
    if (bits_a, bits_x) not in MODES:
        raise ValueError(f"mode {bits_a}x{bits_x}: the iteration kernels "
                         f"take 4x4 and 4x8")
    if phi[0].dim() != 2:
        raise ValueError(f"Phi codes {tuple(phi[0].shape)}: expected 2-D")
    m_pad, wa = phi[0].shape
    n_pad = 2 * wa
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"Phi codes {tuple(phi[0].shape)} not padded to 128")
    _build.check(phi[0], (m_pad, wa), torch.int8, "Phi codes")
    device = phi[0].device
    shapes = (("Phi", phi, (m_pad, wa), (m_pad // BLOCK, n_pad // BLOCK)),
              ("PhiT", phit, (n_pad, m_pad // 2),
               (n_pad // BLOCK, m_pad // BLOCK)),
              ("y", y, (m_pad * bits_x // 8,), (m_pad // BLOCK,)),
              ("x", x, (n_pad * bits_x // 8,), (n_pad // BLOCK,)))
    for name, (codes, scales), cshape, sshape in shapes:
        _build.check(codes, cshape, torch.int8, f"{name} codes", device)
        _build.check(scales, sshape, torch.float32, f"{name} scales", device)
    return m_pad, n_pad, device


def _seed_args(seeds, noise):
    if len(noise) != 4:
        raise ValueError(f"expected 4 SR flags, got {len(noise)}")
    words = (ctypes.c_uint32 * len(seeds))(*(s & 0xFFFFFFFF for s in seeds))
    flags = (ctypes.c_int * 4)(*map(int, noise))
    return words, flags


@tracing.kernel("iteration")
def iteration_cuda(bits_a: int, bits_x: int, phi, phit, y, x, mu: float,
                   seeds=(0, 0, 0, 0), noise=(False,) * 4,
                   grid: int | None = None):
    """Kernel form of :func:`iteration_plain`: one cooperative launch."""
    m_pad, n_pad, device = _operands(bits_a, bits_x, phi, phit, y, x)
    if len(seeds) != 4:
        raise ValueError(f"expected 4 seeds, got {len(seeds)}")
    if n_pad > SIDE_MAX:
        raise ValueError(f"x of {n_pad} padded elements: the iteration "
                         f"kernels take at most {SIDE_MAX}")
    grid = launch_grid(device, bits_a, bits_x, False,
                       max(m_pad, n_pad) // BLOCK, grid)
    xw, yw = n_pad * bits_x // 8, m_pad * bits_x // 8
    # the result first, so its views start 16-byte aligned; t2 after it
    codes = torch.empty(xw + yw, dtype=torch.int8, device=device)
    scales = torch.empty((n_pad + m_pad) // BLOCK, dtype=torch.float32,
                         device=device)
    out, t2 = codes.split([xw, yw])
    out_s, t2_s = scales.split([n_pad // BLOCK, m_pad // BLOCK])
    words, flags = _seed_args(seeds, noise)
    P = _build.ptr
    _build.launch("clover_iteration", device, P(phi[0]), P(phi[1]),
                  P(phit[0]), P(phit[1]), P(y[0]), P(y[1]), P(x[0]), P(x[1]),
                  P(t2), P(t2_s), P(out), P(out_s), m_pad, n_pad, float(mu),
                  bits_a, bits_x, ctypes.addressof(words),
                  ctypes.addressof(flags), grid)
    return out, out_s


@tracing.kernel("iteration_chain")
def iteration_chain_cuda(bits_a: int, bits_x: int, phi, phit, y, x,
                         mu: float, k, seeds, noise=(False,) * 4,
                         grid: int | None = None):
    """Kernel form of :func:`iteration_chain_plain`: one cooperative
    launch for every iteration."""
    m_pad, n_pad, device = _operands(bits_a, bits_x, phi, phit, y, x)
    chain = len(seeds) // 4
    if len(seeds) != 4 * chain or not 1 <= chain <= MAX_CHAIN:
        raise ValueError(f"{len(seeds)} seeds: expected 4 per iteration, "
                         f"1 to {MAX_CHAIN} iterations")
    if k is not None and not 0 <= k < 2 ** 31:
        raise ValueError(f"k={k} out of range")
    if n_pad > SIDE_MAX:
        raise ValueError(f"x of {n_pad} padded elements: the iteration "
                         f"kernels take at most {SIDE_MAX}")
    grid = launch_grid(device, bits_a, bits_x, True,
                       max(m_pad, n_pad) // BLOCK, grid)
    xw, yw, nb = n_pad * bits_x // 8, m_pad * bits_x // 8, n_pad // BLOCK
    codes = torch.empty(3 * xw + yw, dtype=torch.int8, device=device)
    scales = torch.empty(2 * nb + m_pad // BLOCK, dtype=torch.float32,
                         device=device)
    xt, last, other, t2 = codes.split([xw, xw, xw, yw])
    last_s, other_s, t2_s = scales.split([nb, nb, m_pad // BLOCK])
    # iteration it writes slot it & 1; the last one's slot starts the
    # buffers, so the returned views are 16-byte aligned
    slots = ((last, last_s), (other, other_s))
    (xb0, xs0), (xb1, xs1) = slots if (chain - 1) % 2 == 0 else slots[::-1]
    words, flags = _seed_args(seeds, noise)
    P = _build.ptr
    _build.launch("clover_iteration_chain", device, P(phi[0]), P(phi[1]),
                  P(phit[0]), P(phit[1]), P(y[0]), P(y[1]), P(x[0]), P(x[1]),
                  P(t2), P(t2_s), P(xb0), P(xs0), P(xb1), P(xs1), P(xt),
                  m_pad, n_pad, float(mu), -1 if k is None else int(k),
                  chain, bits_a, bits_x, ctypes.addressof(words),
                  ctypes.addressof(flags), grid)
    return (last if k is None else xt), last_s
