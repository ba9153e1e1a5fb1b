"""Edit distance and permutation-WER utilities.

The port's own copy of ``setk_tpu/metrics/wer.py`` (host numpy): a
Levenshtein distance over token sequences and the least total distance
over reference permutations.
"""

from itertools import permutations

import numpy as np

__all__ = ["edit_distance", "permute_ed"]


def edit_distance(hyp, ref) -> int:
    """Levenshtein distance between two token sequences."""
    hyp, ref = list(hyp), list(ref)
    if len(hyp) < len(ref):
        hyp, ref = ref, hyp
    if not ref:
        return len(hyp)
    ref_arr = np.asarray(ref, dtype=object)
    prev = np.arange(len(ref) + 1)
    for i, h in enumerate(hyp, 1):
        cur = np.empty(len(ref) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (ref_arr != h)
        for j in range(1, len(ref) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def permute_ed(hlist, rlist) -> int:
    """Min total edit distance over reference permutations."""
    num = len(hlist)
    if num != len(rlist):
        raise RuntimeError(f"Size mismatch: {num} vs {len(rlist)}")
    dist = np.array([[edit_distance(h, r) for r in rlist] for h in hlist])
    return int(
        min(
            sum(dist[i, p[i]] for i in range(num))
            for p in permutations(range(num))))
