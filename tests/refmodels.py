"""Scalar pure-Python oracles mirroring the reference algorithms exactly.

These are straight transcriptions of the reference's math (cited per
function) used ONLY as test oracles for the vectorized device implementations.
They were validated to reproduce the committed sketch files and results.txt
bit-for-bit before the framework was built.
"""

import gzip
import math

import numpy as np

M64 = (1 << 64) - 1
WYC = 0x60BEE2BEE120FC15
WYX = 0xE7037ED1A0B428DB


def wang(x):
    """sketch/include/sketch/hash.h:42-53."""
    x = ((~x) + (x << 21)) & M64
    x ^= x >> 24
    x = (x + (x << 3) + (x << 8)) & M64
    x ^= x >> 14
    x = (x + (x << 2) + (x << 4)) & M64
    x ^= x >> 28
    x = (x + (x << 31)) & M64
    return x


def canonical(kmer, k=31):
    """src/build_sketch.cpp:26-39."""
    x = kmer
    x = (((x >> 2) & 0x3333333333333333) | ((x & 0x3333333333333333) << 2)) & M64
    x = (((x >> 4) & 0x0F0F0F0F0F0F0F0F) | ((x & 0x0F0F0F0F0F0F0F0F) << 4)) & M64
    x = (((x >> 8) & 0x00FF00FF00FF00FF) | ((x & 0x00FF00FF00FF00FF) << 8)) & M64
    x = (((x >> 16) & 0x0000FFFF0000FFFF) | ((x & 0x0000FFFF0000FFFF) << 16)) & M64
    x = ((x >> 32) | (x << 32)) & M64
    rev = ((M64 - x) & M64) >> (64 - 2 * k)
    return kmer if kmer < rev else rev


CODE = {65: 0, 67: 1, 71: 2, 84: 3, 97: 0, 99: 1, 103: 2, 116: 3}


def kmers_from_fasta(path, k=31):
    """Streaming scanner semantics of src/build_sketch.cpp:62-92."""
    out = []
    mask = (1 << (2 * k)) - 1
    with gzip.open(path, "rb") as fh:
        kmer = 0
        bases = 0
        for line in fh:
            line = line.strip()
            if line.startswith(b">"):
                kmer = 0
                bases = 0
                continue
            for ch in line:
                bases += 1
                c = CODE.get(ch)
                if c is None:
                    c = 0
                    bases = 0
                    kmer = 0
                kmer = ((kmer << 2) | c) & mask
                if bases == k:
                    out.append(canonical(kmer, k))
                    bases -= 1
    return out


def clz64(x):
    return 64 - x.bit_length() if x else 64


def build_hll(kmers, p):
    """hll_t::addh/add (hll.h:886-903)."""
    core = np.zeros(1 << p, dtype=np.uint8)
    q = 64 - p
    for km in kmers:
        h = wang(km)
        idx = h >> q
        lzt = clz64((((h << 1) | 1) << (p - 1)) & M64) + 1
        if core[idx] < lzt:
            core[idx] = lzt
    return core


def wymum(a, b):
    r = a * b
    return ((r & M64) ^ (r >> 64)) & M64


def build_smh_sequential(kmers, m):
    """Faithful sequential SuperMinHash with the a_/b_ early exit
    (bbmh.h:639-670), including the full p_/q_/i_ lazy-reset machinery."""
    mask = m - 1
    a_ = m - 1
    i_ = 0
    p_ = [0] * m
    h_ = [(1 << 64) - 1] * m
    q_ = [0xFFFFFFFF] * m
    b_ = [0] * m
    b_[m - 1] = m
    for km in kmers:
        state = km if km != 0 else 1337
        j = 0
        while j <= a_:
            state = (state + WYC) & M64
            draw = wymum(state ^ WYX, state)
            k = (draw & 0xFFFFFFFF) & mask
            r = draw >> 32
            for x in (j, k):
                if q_[x] != i_:
                    q_[x] = i_
                    p_[x] = x
            p_[k], p_[j] = p_[j], p_[k]
            crj = (j << 32) | r
            if crj < h_[p_[j]]:
                jprime = min(m - 1, h_[p_[j]] >> 32)
                h_[p_[j]] = crj
                if j < jprime:
                    b_[jprime] -= 1
                    b_[j] += 1
                    while b_[a_] == 0:
                        a_ -= 1
            j += 1
        i_ += 1
    return np.array(h_, dtype=np.uint64)


def sum_counts(core):
    c = np.zeros(64, dtype=np.int64)
    vals, cnts = np.unique(np.asarray(core, np.uint8), return_counts=True)
    c[vals] = cnts
    return c


def ertl_ml_estimate(c, p, relerr=1e-2):
    """hll.h:629-688, scalar."""
    q = 64 - p
    m = 1 << p
    if c[q + 1] == m:
        return float("inf")
    k_min = 0
    while c[k_min] == 0:
        k_min += 1
    k_min_p = max(1, k_min)
    k_max = q + 1
    while k_max and c[k_max] == 0:
        k_max -= 1
    k_max_p = min(q, k_max)
    z = 0.0
    for k in range(k_max_p, k_min_p - 1, -1):
        z = 0.5 * z + float(c[k])
    z = math.ldexp(z, -k_min_p)
    c_prime = int(c[q + 1])
    if q:
        c_prime += int(c[k_max_p])
    a = z + float(c[0])
    m_prime = m - int(c[0])
    gprev = z + math.ldexp(float(c[q + 1]), -q)
    x = m_prime / (0.5 * gprev + a) if gprev <= 1.5 * a else (m_prime / gprev) * math.log1p(gprev / a)
    gprev = 0.0
    delta_x = x
    relerr /= math.sqrt(m)
    while delta_x > x * relerr:
        _, kappa_m1 = math.frexp(x)
        x_prime = math.ldexp(x, -max(k_max_p + 1, kappa_m1 + 2))
        x_pp = x_prime * x_prime
        h = x_prime - x_pp / 3 + (x_pp * x_pp) * (1.0 / 45.0 - x_pp / 472.5)
        k = kappa_m1
        while k >= k_max_p:
            h_prime = 1.0 - h
            h = (x_prime + h * h_prime) / (x_prime + h_prime)
            x_prime += x_prime
            k -= 1
        g = c_prime * h
        k = k_max_p - 1
        while k >= k_min_p:
            h_prime = 1.0 - h
            h = (x_prime + h * h_prime) / (x_prime + h_prime)
            x_prime += x_prime
            g += float(c[k]) * h
            k -= 1
        g += x * a
        if gprev < g <= m_prime:
            delta_x *= (g - m_prime) / (gprev - g)
        else:
            delta_x = 0
        x += delta_x
        gprev = g
    return x * m


def report(core, p):
    return ertl_ml_estimate(sum_counts(core), p)


def union_size(c1, c2, p):
    return ertl_ml_estimate(sum_counts(np.maximum(c1, c2)), p)
