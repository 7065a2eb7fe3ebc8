"""Inputs on which one TF32 product per f32 product fails a kernel's limit and
split TF32 (three products, hi + lo parts) passes it, and a numpy emulation of
both arithmetics.

K5's ``tf32x3`` variant and the ``tf32`` variants of K1, K2 and K3 multiply f32
operands on the TF32 tensor cores. A TF32 value keeps 10 of f32's 23 mantissa bits; each f32
operand x is split into ``hi``, x rounded to TF32, and ``lo``, ``x - hi`` cut
to TF32, and a product is ``a_hi b_hi + a_hi b_lo + a_lo b_hi``. The probes
below are built so that the limits the kernels are held to (K5: 1e-5 absolute
on the output; K1: 1e-4 absolute on lse; K2 and K3: 1e-4 of the largest |dh|
or |dW|) see the difference, even where only one operand (``K5_OPERANDS``,
``K1_OPERANDS``, ``K2_OPERANDS``, ``K3_OPERANDS``) loses its lo part: the
tests on the card run the kernels on them, and the CPU tests run this
emulation, which shows without a card that each probe tells the arithmetics
apart.

The emulation rounds and cuts operands as the kernels do (hi to nearest at 10
mantissa bits, ties away from zero, as ``cvt.rna.tf32.f32``; lo toward zero)
and sums in float64, so that only the operands' rounding is modelled; the card
sums in f32.
"""

import numpy as np

K5_OPERANDS = ("q", "k", "p", "v")  # S = q kᵀ, out = p v
K1_OPERANDS = ("h", "w")  # logits = h wᵀ
K2_OPERANDS = ("h", "w", "p")  # logits = h wᵀ, dh = p w
K3_OPERANDS = ("h", "w", "p")  # logits = h wᵀ, dW = pᵀ h
K5_LIMIT = 1e-5  # K5 in f32 against its plain version, max abs error
K1_LIMIT = 1e-4  # K1 in f32 against its plain version, max abs error of lse
K2_LIMIT = 1e-4  # K2 in f32 against its plain version, over the largest |dh|
K3_LIMIT = 1e-4  # K3 with an f32 table against its plain version, over the largest |dW|


def tf32(x) -> np.ndarray:
    """f32 values rounded to TF32, to nearest with ties away from zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def parts(x):
    """``(hi, lo)``, both TF32, with hi + lo carrying x to about 2**-21: hi
    rounded to nearest, lo (``x - hi``, exact in f32) cut toward zero."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32(x)
    lo = np.ascontiguousarray(x - hi, dtype=np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def matmul(a, b, a_lo: bool, b_lo: bool) -> np.ndarray:
    """``a @ b`` of f32 operands as the tensor cores take it, float64 sums:
    each operand as its hi part, plus its lo part where ``a_lo`` / ``b_lo``
    say so; the products ``a_hi b_hi``, ``a_hi b_lo`` and ``a_lo b_hi`` of the
    parts there are (three when both keep a lo part, one when neither does)."""
    (a_hi, a_low), (b_hi, b_low) = parts(a), parts(b)
    a_hi, a_low, b_hi, b_low = (t.astype(np.float64) for t in (a_hi, a_low, b_hi, b_low))
    out = a_hi @ b_hi
    if b_lo:
        out = a_hi @ b_low + out
    if a_lo:
        out = a_low @ b_hi + out
    return out


def k5_probe(seed: int = 31):
    """``q, k, v`` ``[1, 1, 64, 64]`` f32 and a ``[1, 64]`` padding mask with
    keys 0 and 1 real: every output row is a softmax blend of two V rows of
    magnitude about 4 whose values use all 24 mantissa bits, from scores of
    order 1. One TF32 product per pair moves the output by about 2**-12 of |V|,
    far past 1e-5, and so does dropping the lo part of any one operand; three
    keep it near 2**-21 of |V|."""
    rng = np.random.default_rng(seed)
    length, dim = 64, 64
    q = rng.standard_normal((1, 1, length, dim)).astype(np.float32)
    k = rng.standard_normal((1, 1, length, dim)).astype(np.float32)
    v = (4 * rng.standard_normal((1, 1, length, dim))).astype(np.float32)
    padding = np.zeros((1, length), dtype=bool)
    padding[0, :2] = True
    return q, k, v, padding


def k5_emulated(q, k, v, padding, lo=None) -> np.ndarray:
    """K5 on ``k5_probe``'s inputs (non-causal, one batch row and head):
    exactly (float64) for ``lo=None``, else both products in TF32, the
    operands named in ``lo`` (of ``K5_OPERANDS``) split into hi + lo parts and
    the others rounded to one TF32 part; P, as the kernel keeps it, is f32."""
    q, k, v = q[0, 0], k[0, 0], v[0, 0]
    scale = np.float32(1.0) / np.sqrt(np.float32(q.shape[-1]))
    s = q.astype(np.float64) @ k.T.astype(np.float64) if lo is None else matmul(q, k.T, "q" in lo, "k" in lo)
    s = np.where(padding[0][None, :], s * np.float64(scale), -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    denom = p.sum(axis=-1, keepdims=True)
    if lo is None:
        return (p @ v.astype(np.float64)) / denom
    return matmul(p.astype(np.float32), v, "p" in lo, "v" in lo) / denom


def k3_probe(seed: int = 32):
    """``h`` ``[256, 64]`` f32 in row pairs ``x`` and ``x + d`` (|x| in [4, 8),
    d about 0.2), ``g`` +1 and -1 in turn, and a 64-item table whose logits
    have a spread of about 4 (each row's largest softmax weight about 0.6):
    dW is a sum of the pairs' differences, small beside its terms. One TF32
    product per pair moves it by about 2**-12 of |x| per row, far past 1e-4 of
    |dW|; dropping only W's lo part moves the logits by about 2**-12 of their
    size, and the weights with them, past it too; three products keep dW near
    2**-21 of |x|."""
    rng = np.random.default_rng(seed)
    rows, dim, items = 256, 64, 64
    x = (rng.uniform(4.0, 8.0, (rows // 2, dim)) * rng.choice([-1.0, 1.0], (rows // 2, dim))).astype(np.float32)
    d = (0.2 * rng.standard_normal((rows // 2, dim))).astype(np.float32)
    h = np.empty((rows, dim), dtype=np.float32)
    h[0::2], h[1::2] = x, x + d
    g = np.tile(np.array([1.0, -1.0], dtype=np.float32), rows // 2)
    table = (rng.standard_normal((items, dim)) * (4.0 / 6.0 / np.sqrt(dim))).astype(np.float32)
    return h, table, g


def k3_emulated(h, table, g, lo=None) -> np.ndarray:
    """K3 on these inputs, its lse from the exact logits: ``dW = (g·softmax)ᵀ h``
    exactly (float64) for ``lo=None``, else with both products in TF32, the
    operands named in ``lo`` (of ``K3_OPERANDS``) split into hi + lo parts and
    the others rounded to one TF32 part; the weights, as the kernel keeps
    them, are f32."""
    exact = h.astype(np.float64) @ table.T.astype(np.float64)
    top = exact.max(axis=-1, keepdims=True)
    lse = top + np.log(np.exp(exact - top).sum(axis=-1, keepdims=True))
    logits = exact if lo is None else matmul(h, table.T, "h" in lo, "w" in lo)
    weights = g[:, None].astype(np.float64) * np.exp(logits - lse)
    if lo is None:
        return weights.T @ h.astype(np.float64)
    return matmul(weights.T.astype(np.float32), h, "p" in lo, "h" in lo)


def lse_probe(seed: int = 33):
    """The probe of K1 and K2: ``h`` ``[128, 64]`` f32, a 128-item table and
    ``g``. The first 32 columns carry the logits: h about 3 and the table about
    0.25 there, so every logit is about 30 and a rounding of h or W of 2**-12
    moves it by about 1e-3, which lse takes whole (K1) and the weights
    ``g exp(logit - lse)`` take as a relative error against the given lse (K2);
    the logits spread so that each row's largest softmax weight is about 0.15.
    The last 32 columns of h are 0 and those of the table come in item pairs
    ``x`` and ``-x + d`` (|x| in [4, 8), d about 0.2) whose logits differ by
    about 1%: there dh is a sum of the pairs' differences, small beside its
    terms, so that a rounding of the weights P or of W in ``dh = P W`` moves it
    past 1e-4 of the largest |dh| too. Split TF32 keeps both errors near 2**-21
    of the terms."""
    rng = np.random.default_rng(seed)
    rows, dim, items = 128, 64, 128
    half = dim // 2
    h = np.zeros((rows, dim), dtype=np.float32)
    h[:, :half] = 3.0 + rng.standard_normal((rows, half))
    table = np.empty((items, dim), dtype=np.float32)
    base = 0.25 + 0.1 * rng.standard_normal((items // 2, half))
    table[0::2, :half] = base
    table[1::2, :half] = base + 0.02 * rng.standard_normal((items // 2, half))
    x = rng.uniform(4.0, 8.0, (items // 2, half)) * rng.choice([-1.0, 1.0], (items // 2, half))
    table[0::2, half:] = x
    table[1::2, half:] = -x + 0.2 * rng.standard_normal((items // 2, half))
    g = rng.standard_normal(rows).astype(np.float32)
    return h, table, g


def _exact_lse(h, table) -> np.ndarray:
    logits = h.astype(np.float64) @ table.T.astype(np.float64)
    top = logits.max(axis=-1, keepdims=True)
    return top + np.log(np.exp(logits - top).sum(axis=-1, keepdims=True))


def k1_emulated(h, table, lo=None) -> np.ndarray:
    """K1 on these inputs, ``[N]`` lse: exactly (float64) for ``lo=None``, else
    with the logits in TF32, the operands named in ``lo`` (of ``K1_OPERANDS``)
    split into hi + lo parts and the others rounded to one TF32 part."""
    if lo is None:
        return _exact_lse(h, table)[:, 0]
    logits = matmul(h, table.T, "h" in lo, "w" in lo)
    top = logits.max(axis=-1, keepdims=True)
    return (top + np.log(np.exp(logits - top).sum(axis=-1, keepdims=True)))[:, 0]


def k2_emulated(h, table, g, lo=None) -> np.ndarray:
    """K2 on these inputs, its lse from the exact logits: ``dh = (g·softmax) W``
    exactly (float64) for ``lo=None``, else with both products in TF32, the
    operands named in ``lo`` (of ``K2_OPERANDS``) split into hi + lo parts and
    the others rounded to one TF32 part; the weights, as the kernel keeps
    them, are f32."""
    lse = _exact_lse(h, table)
    logits = h.astype(np.float64) @ table.T.astype(np.float64) if lo is None else matmul(h, table.T, "h" in lo, "w" in lo)
    weights = g[:, None].astype(np.float64) * np.exp(logits - lse)
    if lo is None:
        return weights @ table.astype(np.float64)
    return matmul(weights.astype(np.float32), table, "p" in lo, "w" in lo)
