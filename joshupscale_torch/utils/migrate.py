"""Structural weight migration between differently shaped models.

The port's copy of ``joshupscale_tpu/utils/migrate.py`` (the registry's
``copy_variables``): when an architecture grows or shrinks (progressive
growing adds res blocks), weights are migrated by walking both trees'
leaves in order and aligning them by a longest common subsequence on
(leaf name, shape); destination leaves left unmatched keep their
initialization.  The port's layouts are permutations of the
reference's, the same for every leaf of a kind, so shapes match where
the reference's do.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np


def lcs(a: List[Any], b: List[Any], key=lambda x: x) -> List[Tuple[int,
                                                                   int]]:
    """Longest common subsequence of ``a`` and ``b`` under ``key``: the
    matched index pairs, ties broken as the reference breaks them."""
    ka = [key(x) for x in a]
    kb = [key(x) for x in b]
    n, m = len(a), len(b)
    table = np.zeros((n + 1, m + 1), np.int32)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if ka[i] == kb[j]:
                table[i, j] = table[i + 1, j + 1] + 1
            else:
                table[i, j] = max(table[i + 1, j], table[i, j + 1])
    pairs = []
    i = j = 0
    while i < n and j < m:
        if ka[i] == kb[j]:
            pairs.append((i, j))
            i += 1
            j += 1
        elif table[i + 1, j] >= table[i, j + 1]:
            i += 1
        else:
            j += 1
    return pairs


def _ordered_leaves(tree, prefix=""):
    """``(dotted path, leaf)`` in the tree's insertion order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k, v in tree.items():
        out.extend(_ordered_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def copy_model_variables(dst_tree, src_tree, verbose: bool = False):
    """``dst_tree`` with the leaves an LCS over (leaf name, shape) matches
    in ``src_tree`` taken from it: the full path is ignored (a depth
    change shifts block indices), order does the rest.  Returns a new
    tree shaped like ``dst_tree``."""
    dst_leaves = _ordered_leaves(dst_tree)
    src_leaves = _ordered_leaves(src_tree)

    def sig(item):
        path, leaf = item
        return (path.rsplit(".", 1)[-1], tuple(leaf.shape))

    pairs = lcs(dst_leaves, src_leaves, key=sig)
    replacements = {dst_leaves[i][0]: src_leaves[j][1] for i, j in pairs}
    if verbose:
        print(f"copy_model_variables: matched {len(pairs)}/"
              f"{len(dst_leaves)} destination variables")

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return replacements.get(prefix, tree)

    return rebuild(dst_tree)
