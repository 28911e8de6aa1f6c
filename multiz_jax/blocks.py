"""MAF block algebra: revcomp, slicing, partial-block emission, sorting.

Vectorized re-implementation of the reference's multi_util.c / maf.c block
operations (cited per function). Operates on multiz_jax.maf.Ali/Comp with
numpy uint8 texts; all coordinate recomputation uses cumulative-sum position
maps instead of per-character scans.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import scores as sc
from .maf import Ali, Comp, DASH, col_back_over_dashes, pos2col

# DNA complement table, byte-for-byte from multi_util.c:34-41 (note: '-' maps
# to '-', unmapped characters map to ' ').
_COMPL_STR = (
    "                                             -                  "
    " TVGH  CD  M KN   YSA BWXR       tvgh  cd  m kn   ysa bwxr      "
    "                                                                "
    "                                                                "
)
DNA_COMPL = np.frombuffer(_COMPL_STR.encode("latin-1"), dtype=np.uint8).copy()


def revcomp_text(text: np.ndarray) -> np.ndarray:
    """do_revcompl (multi_util.c:44-53)."""
    return DNA_COMPL[text[::-1]]


def rev_comp_comp(c: Comp, text_size: int) -> None:
    """rev_comp (multi_util.c:55-59), in place."""
    c.start = c.src_size - (c.start + c.size)
    c.strand = "+" if c.strand == "-" else "-"
    c.text = revcomp_text(c.text)


def rc(a: Ali) -> None:
    """Reverse-complement every component (multi_util.c:62-67)."""
    for c in a.comps:
        rev_comp_comp(c, a.text_size)


def flip_comp(a: Ali) -> None:
    """Swap the first two rows; normalize new top to '+' (multi_util.c:441-458)."""
    if not a.comps:
        raise ValueError("alignment does not have rows")
    if len(a.comps) < 2:
        return
    a.comps[0], a.comps[1] = a.comps[1], a.comps[0]
    c2 = a.comps[0]
    if c2.strand == "-":
        for c in (a.comps[0], a.comps[1]):
            rev_comp_comp(c, a.text_size)


def flip_comps(alis: List[Ali]) -> None:
    for a in alis:
        flip_comp(a)


def score_of(a: Ali, sp: sc.ScoreParams | None = None) -> float:
    return sc.score_range(a, 0, a.text_size, sp=sp)


def col_dash_rm(a: Optional[Ali]) -> Optional[Ali]:
    """Remove all-dash columns in place (mafColDashRm, maf.c:357-381)."""
    if a is None or not a.comps:
        return a
    texts = a.texts()
    keep = (texts != DASH).any(axis=0)
    if not keep.all():
        for c in a.comps:
            c.text = c.text[keep]  # fancy indexing: already a fresh array
    return a


def row_dash_rm(a: Optional[Ali]) -> Optional[Ali]:
    """Drop all-dash rows; None if nothing left (mafRowDashRm, maf.c:384-417)."""
    if a is None:
        return None
    a.comps = [c for c in a.comps if bool((c.text != DASH).any())]
    if not a.comps:
        return None
    return a


def maf_slice(a: Ali, start_col: int, beyond_col: int) -> Ali:
    """mafSlice (multi_util.c:662-687): column slice keeping all rows,
    score unset."""
    out = Ali(score=a.score)
    for c in a.comps:
        nc = c.copy(text=c.text[start_col:beyond_col])  # view: no memcpy
        nc.start = c.start + c.nondash_before(start_col)
        nc.size = int(np.count_nonzero(nc.text != DASH))
        out.comps.append(nc)
    return out


def make_part_ali(a: Ali, cbeg: int, cend: int,
                  sp: sc.ScoreParams | None = None) -> Optional[Ali]:
    """make_part_ali (maf.c:488-523): slice, drop dash rows, rescore."""
    out = maf_slice(a, cbeg, cend + 1)
    out = row_dash_rm(out)
    if out is not None:
        out.score = sc.score_range(out, 0, cend - cbeg + 1, sp=sp)
    return out


def make_part_ali_col(a: Ali, cbeg: int, cend: int,
                      sp: sc.ScoreParams | None = None) -> Optional[Ali]:
    """make_part_ali_col (multi_util.c:570-617): slice columns, drop dash
    rows, remove dash columns, rescore."""
    if cend - cbeg + 1 == 0:
        return None
    out = Ali()
    for c in a.comps:
        pm = c.pos_map()
        before = int(pm[cbeg - 1]) if cbeg > 0 else 0
        chs = int(pm[cend]) - before
        if chs == 0:
            continue
        nc = c.copy(text=c.text[cbeg : cend + 1])  # view: no memcpy
        nc.start = c.start + before
        nc.size = chs
        out.comps.append(nc)
    if not out.comps:
        return None
    out = col_dash_rm(out)
    if out is not None:
        out.score = sc.score_range(out, 0, out.text_size, sp=sp)
    return out


def part_ali_by_pos(a: Ali, beg: int, end: int,
                    sp: sc.ScoreParams | None = None) -> Optional[Ali]:
    """print_part_ali (multi_util.c:515-568): beg/end are top-row sequence
    positions; emits the column range without dash-column removal."""
    top = a.comps[0]
    rel_beg = beg - top.start
    rel_end = end - top.start
    nond = top.nd_idx()
    # C returns silently unless 0 <= rel_beg <= rel_end < #non-dash
    if not (0 <= rel_beg <= rel_end < nond.shape[0]):
        return None
    col_beg = int(nond[rel_beg])
    col_end = int(nond[rel_end])
    out = Ali(score=sc.score_range(a, col_beg, col_end - col_beg + 1, sp=sp))
    for c in a.comps:
        pm = c.pos_map()
        before = int(pm[col_beg - 1]) if col_beg > 0 else 0
        chs = int(pm[col_end]) - before
        if chs == 0:
            continue
        nc = c.copy(text=c.text[col_beg : col_end + 1])  # view
        nc.start = c.start + before
        nc.size = chs
        out.comps.append(nc)
    if not out.comps:
        return None
    return out


def keep_ali(a: Ali, beg: int, sp: sc.ScoreParams | None = None) -> Ali:
    """Truncate a block to start at top-row position beg
    (multi_util.c:468-511). Returns a NEW Ali; the input block and its
    comps are left intact — deferred DP coroutines hold references to
    scan-time blocks, and this non-mutating contract is what lets them
    skip per-overlap snapshot copies (preyama.pre_yama_gen)."""
    top = a.comps[0]
    col_beg = col_back_over_dashes(top, beg)
    new_comps = []
    for c in a.comps:
        count = c.nondash_before(col_beg)
        if c.size - count < 1:
            continue
        text = c.text
        nc = c.copy(text=text[col_beg:])  # view: no memcpy
        nc.start += count
        nc.size -= count
        # Derive the child's coordinate caches from the parent's by
        # offset arithmetic instead of re-scanning the text: blocks are
        # truncated repeatedly by the merge scan and the repeated
        # cumsum/flatnonzero over fresh views dominates at high row
        # counts. (nondash_before above just forced the parent's pm.)
        pm = c._pm
        if pm is not None and pm[0] is text:
            nc._pm = (nc.text, pm[1][col_beg:] - count)
        nd = c._nd
        if nd is not None and nd[0] is text:
            nc._nd = (nc.text, nd[1][count:] - col_beg)
        new_comps.append(nc)
    out = Ali(comps=new_comps)
    if new_comps:
        # lazy: most truncated blocks are re-truncated or consumed by
        # the next overlap DP before anyone reads the score (the write
        # path reads it and pays the one rescore then)
        out.set_lazy_score(
            lambda: sc.score_range(out, 0, out.text_size, sp=sp)
        )
    return out


def sort_by_top_start(alis: List[Ali]) -> List[Ali]:
    """mafArray / maf_sort_top ordering: stable sort by top-row start
    (multi_util.c:126-149; glibc qsort is a stable merge sort here)."""
    return sorted(alis, key=lambda a: a.comps[0].start)


def separate_by_src(alis: List[Ali], src: str):
    """seperate_cp_wk (multi_util.c:816-843): stable partition by top src."""
    wk = [a for a in alis if a.comps[0].src == src]
    cp = [a for a in alis if a.comps[0].src != src]
    return cp, wk


def ref_to_top(alis: List[Ali], ref: str, collect_unused: bool = False):
    """ref_mvto_top (maf_sort.c:23-53): move ref row to top, rc to '+',
    drop (or collect) blocks without ref. NOTE: output order is the REVERSE
    of input order (the C builds a push-front list), which maf_sort_top's
    stable sort then preserves for equal starts."""
    kept: List[Ali] = []
    unused: List[Ali] = []
    for a in alis:
        idx = None
        for i, c in enumerate(a.comps):
            if c.name == ref or c.src == ref:
                idx = i
                break
        if idx is None:
            if collect_unused:
                unused.append(a)
            continue
        if idx != 0:
            c = a.comps.pop(idx)
            a.comps.insert(0, c)
        if a.comps[0].strand != "+":
            rc(a)
        kept.append(a)
    kept.reverse()
    unused.reverse()
    return kept, unused


def maf_sort_list(alis: List[Ali], ref: str, collect_unused: bool = False):
    """maf_sort_list (maf_sort.c:80-86)."""
    kept, unused = ref_to_top(alis, ref, collect_unused)
    return sort_by_top_start(kept), unused
