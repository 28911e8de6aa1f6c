"""Used-region bookkeeping and pairwise-support checks (align_util.c).

Port of the reference's cross-file consistency machinery: `uAli` blocks
with per-column used maps, per-species sorted indexes, the K*J pairwise
file collection (`create_pws`, align_util.c:318-341), the >=50%
pairwise-support gate `connectionAgreement2` (align_util.c:520-659),
the inferred-region marker `mark_infered_pws` (align_util.c:662-758)
and the greedy max-extension cover query `Find_Exemplar`
(align_util.c:760-832). These functions have no callers in the
reference's *built* binaries (the multic/tba bridge paths that used
them are compiled out), but they are part of the library surface;
`pre_yama2` (multiz_jax/preyama.py) consumes `connectionAgreement2`
exactly as mz_preyama.c:436 does.

Tunables mirror align_util.c:7-8 and multi_util.c:18-21.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .blocks import make_part_ali, rc, rev_comp_comp
from .maf import Ali, Comp, col2pos_after, col2pos_before, pos2col, read_maf

CONNECTION_THRESHOLD = 50  # align_util.c:7
SAME_CONNECTION = 30  # align_util.c:8
OVERLAP_THRESHOLD = 50  # multi_util.c:18
OVERLAP_LEN_THREH = 300  # multi_util.c:21

INT32_MIN = -(2**31)


def _c_double_to_int(v: float) -> int:
    """x86-64 (double)->(int) cast: truncate toward zero; NaN and
    out-of-range produce INT_MIN (cvttsd2si semantics)."""
    if v != v or v >= 2**31 or v < -(2**31):
        return INT32_MIN
    return int(v)


def overlap(beg1: int, end1: int, beg2: int, end2: int) -> int:
    """multi_util.c:927-944: >=50% mutual overlap or >=300 bases."""
    if beg2 > end1 or beg1 > end2:
        return 0
    over_beg = max(beg1, beg2)
    over_end = min(end1, end2)
    over_len = over_end - over_beg + 1
    thr = OVERLAP_THRESHOLD / 100.0
    if (
        over_len / (end1 - beg1 + 1) > thr
        or over_len / (end2 - beg2 + 1) > thr
        or over_len >= OVERLAP_LEN_THREH
    ):
        return 1
    return 0


@dataclass
class UAli:
    """struct uAli (align_util.h:22-30): a block + per-column use map."""

    ali: Ali
    used: np.ndarray = field(init=False)  # uint8 'u'/'o'
    sort_contig: Optional[str] = None
    start: int = -1
    end: int = -1
    index: int = -1
    flipped: bool = False
    next: Optional["UAli"] = None

    def __post_init__(self):
        self.used = np.full(self.ali.text_size, ord("u"), np.uint8)


def rc_uali(a: UAli) -> None:
    """rc_uAli (align_util.c:69-81): revcomp block + reverse used map."""
    rc(a.ali)
    a.used = a.used[::-1].copy()
    a.flipped = not a.flipped


def mark_uali(A: UAli, Beg: int, End: int, nalilist: List[Ali]) -> None:
    """mark_uAli (align_util.c:83-143): mark [Beg, End] of A's top row
    'o' for every nali whose rows are all consistent with A's rows."""
    used = A.used
    for nali in nalilist:
        cond = 0
        for ncomp in nali.comps:
            comp = next(
                (c for c in A.ali.comps if c.name == ncomp.name), None
            )
            if comp is not None:
                nstart = ncomp.start
                nend = ncomp.start + ncomp.size - 1
                ustart = comp.start
                uend = comp.start + comp.size - 1
                if ncomp.strand != comp.strand:
                    uend = comp.src_size - comp.start - 1
                    ustart = uend - (comp.size - 1)
                if (
                    ncomp.src != comp.src
                    or nstart > uend
                    or ustart > nend
                ):
                    cond = 1
                    break
        if cond == 1:
            continue
        comp = A.ali.comps[0]
        ncomp = next(
            (c for c in nali.comps if c.name == comp.name), None
        )
        if ncomp is None:
            continue
        if ncomp.strand == "+":
            nbeg = ncomp.start
        else:
            nbeg = ncomp.src_size - ncomp.start - ncomp.size - 1
        nend = nbeg + ncomp.size - 1
        beg = max(Beg, nbeg)
        end = min(End, nend)
        nbeg = max(beg, comp.start)
        nend = min(end, comp.start + comp.size - 1)
        if nbeg > nend:
            continue
        cbeg = pos2col(comp, nbeg)
        cend = pos2col(comp, nend)
        used[cbeg : cend + 1] = ord("o")


def print_unused_ali(iali: UAli, sink, sp=None) -> None:
    """print_unused_ali (align_util.c:144-169): emit maximal 'u' runs."""
    if sink is None or iali.ali is None:
        return
    ali = iali.ali
    size = ali.text_size
    unused = iali.used
    i = 0
    while i < size:
        while i < size and unused[i] == ord("o"):
            i += 1
        if i >= size:
            break
        j = i
        while j < size and unused[j] == ord("u"):
            j += 1
        j -= 1
        nali = make_part_ali(ali, i, j, sp=sp)
        if nali is not None:
            sink(nali)
        i = j + 1


@dataclass
class SortUAlis:
    """struct sortuAlis (align_util.h:33-38): blocks containing one
    species, sorted by (contig, oriented start)."""

    arr: List[UAli]
    fronts: np.ndarray
    ends: np.ndarray
    species: str


def do_sort_ualis(ualis: List[UAli], name: str) -> SortUAlis:
    """do_sortuAlis (align_util.c:200-243)."""
    sel = []
    for u in ualis:
        comp = next((c for c in u.ali.comps if c.name == name), None)
        if comp is None:
            continue
        u.sort_contig = comp.contig
        if comp.strand == "+":
            u.start = comp.start
        else:
            u.start = comp.src_size - comp.start - comp.size
        u.end = u.start + comp.size - 1
        sel.append(u)
    # sort_uAli_contigs (align_util.c:180-198): by contig, then start
    sel.sort(key=lambda u: (u.sort_contig, u.start))
    return SortUAlis(
        arr=sel,
        fronts=np.array([u.start for u in sel], dtype=np.int64),
        ends=np.array([u.end for u in sel], dtype=np.int64),
        species=name,
    )


class UAliFile:
    """struct uAliFile (align_util.h:41-48): blocks of one file plus
    per-species sorted indexes (initialize_uAliFile,
    align_util.c:245-295)."""

    def __init__(self, blocks: List[Ali], filename: Optional[str] = None):
        self.filename = filename
        self.ualis = [UAli(a) for a in blocks]
        for i, u in enumerate(self.ualis):
            u.index = i
        names: List[str] = []
        for a in blocks:
            for c in a.comps:
                if c.name not in names:
                    names.append(c.name)
        self.species_names = names
        self.sorted: Dict[str, SortUAlis] = {
            n: do_sort_ualis(self.ualis, n) for n in names
        }

    @property
    def uali_count(self) -> int:
        return len(self.ualis)

    @property
    def species_count(self) -> int:
        return len(self.species_names)


class PwUAliFiles:
    """struct pwuAliFiles: the K*J pairwise files left.right.postfix
    (create_pws, align_util.c:318-341)."""

    def __init__(self, left_names, right_names, postfix: str,
                 src_dir: str = "."):
        self.files: List[UAliFile] = []
        for ln in left_names:
            for rn in right_names:
                fn = f"{ln}.{rn}.{postfix}"
                blocks = read_maf(os.path.join(src_dir, fn), verbose=False)
                self.files.append(UAliFile(blocks, filename=fn))

    @property
    def pair_k(self) -> int:
        return len(self.files)


create_pws = PwUAliFiles


def form_name_list(s: str) -> List[str]:
    """formNameList (align_util.c:344-366): splits on spaces building
    the list head-first, i.e. REVERSED relative to the input order —
    which fixes create_pws's pair-file ordering."""
    return list(reversed(s.split()))


def _find_pair_file(pws: PwUAliFiles, name_a: str, name_b: str):
    """The pair-file lookup loop shared by connectionAgreement2 and
    mark_infered_pws (align_util.c:556-570)."""
    for i, f in enumerate(pws.files):
        if f.uali_count == 0:
            continue
        if f.species_count < 2:
            raise ValueError(
                "pairwise alignment species number less than 2"
            )
        top, bot = f.species_names[0], f.species_names[1]
        if (name_a == top and name_b == bot) or (
            name_a == bot and name_b == top
        ):
            return i, f
    return None, None


def _pw_comps(pw: Ali, name_a: str):
    if pw.comps[0].name == name_a:
        return pw.comps[0], pw.comps[1]
    return pw.comps[1], pw.comps[0]


def connection_agreement2(
    leftali: Ali, rightali: Ali, cbeg1: int, cend1: int,
    cbegN: int, cendN: int, pws: PwUAliFiles,
) -> int:
    """connectionAgreement2 (align_util.c:520-659): is the proposed merge
    of leftali[cbeg1..cend1] with rightali[cbegN..cendN] supported by at
    least CONNECTION_THRESHOLD percent of the row-pairwise alignments,
    with midpoint colinearity tolerance SAME_CONNECTION?"""
    if leftali.comps[0].strand == "-":
        raise ValueError(
            "left top component is not positive orientation: "
            + leftali.comps[0].name
        )
    left_k = len(leftali.comps)
    right_k = len(rightali.comps)
    exist = np.zeros(pws.pair_k, dtype=np.int64)
    expect = left_k * right_k

    for compA in list(leftali.comps):
        marker1 = 0
        if compA.strand == "-":
            # the C flips ONLY compA's row plus every row of rightali
            # (align_util.c:544-555)
            rev_comp_comp(compA, leftali.text_size)
            for cB in rightali.comps:
                rev_comp_comp(cB, rightali.text_size)
            cbegN, cendN = (
                rightali.text_size - cendN - 1,
                rightali.text_size - cbegN - 1,
            )
            cbeg1, cend1 = (
                leftali.text_size - cend1 - 1,
                leftali.text_size - cbeg1 - 1,
            )
            marker1 = 1
        for compB in rightali.comps:
            i, f = _find_pair_file(pws, compA.name, compB.name)
            if f is None:
                continue
            sal = f.sorted.get(compA.name)
            if sal is None:
                raise ValueError(f"no sorted species: {compA.name}")
            for j in range(len(sal.arr)):
                if sal.fronts[j] > compA.start + compA.size - 1:
                    continue
                if sal.ends[j] < compA.start:
                    continue
                pw = sal.arr[j].ali
                compa, compb = _pw_comps(pw, compA.name)
                if (
                    compa.contig != compA.contig
                    or compb.contig != compB.contig
                ):
                    continue
                if compa.strand == "+" and compb.strand != compB.strand:
                    continue
                marker2 = 0
                if compa.strand == "-":
                    if compb.strand == compB.strand:
                        continue
                    rc(pw)
                    compa, compb = _pw_comps(pw, compA.name)
                    marker2 = 1
                ax = beg2 = col2pos_after(compA, cbeg1)
                bx = end2 = col2pos_before(compA, cend1)
                overbeg = max(beg2, compa.start)
                overend = min(end2, compa.start + compa.size - 1)
                if overbeg > overend:
                    # NB: the reference `continue`s here WITHOUT undoing
                    # the marker2 rev_comp (align_util.c:610-612) — the
                    # pw block stays flipped; replicated faithfully.
                    continue
                ay = beg1 = col2pos_after(compB, cbegN)
                by = end1 = col2pos_before(compB, cendN)
                cbeg = pos2col(compa, overbeg)
                cend = pos2col(compa, overend)
                beg2 = col2pos_after(compb, cbeg)
                end2 = col2pos_before(compb, cend)
                if overlap(beg1, end1, beg2, end2) == 1:
                    cx = compa.start
                    cy = compb.start
                    dx = compa.start + compa.size - 1
                    dy = compb.start + compb.size - 1
                    overbeg = max(ax, cx)
                    overend = min(bx, dx)
                    overmid = (overbeg + overend) // 2
                    ab_mid_y = _c_double_to_int(
                        by - (bx - overmid) * (by - ay) / float(bx - ax)
                    ) if bx != ax else _c_double_to_int(float("nan"))
                    cd_mid_y = _c_double_to_int(
                        dy - (dx - overmid) * (dy - cy) / float(dx - cx)
                    ) if dx != cx else _c_double_to_int(float("nan"))
                    if (
                        -SAME_CONNECTION
                        <= ab_mid_y - cd_mid_y
                        <= SAME_CONNECTION
                    ):
                        exist[i] = 1
                if marker2 == 1:
                    rc(pw)
        if marker1 == 1:
            rev_comp_comp(compA, leftali.text_size)
            for cB in rightali.comps:
                rev_comp_comp(cB, rightali.text_size)
            cbegN, cendN = (
                rightali.text_size - cendN - 1,
                rightali.text_size - cbegN - 1,
            )
            cbeg1, cend1 = (
                leftali.text_size - cend1 - 1,
                leftali.text_size - cbeg1 - 1,
            )

    if int(exist.sum()) * 100 // expect >= CONNECTION_THRESHOLD:
        return 1
    return 0


def mark_infered_pws(nlist: List[Ali], pws: PwUAliFiles) -> int:
    """mark_infered_pws (align_util.c:662-758): mark pairwise regions
    explained by the multi-blocks in nlist as used ('o')."""
    for nali in nlist:
        comps = nali.comps
        for ia, compA in enumerate(comps):
            for compB in comps[ia + 1 :]:
                i, f = _find_pair_file(pws, compA.name, compB.name)
                if f is None:
                    continue
                line1 = 0
                if compA.strand != "+":
                    # only the two participating rows flip
                    # (align_util.c:687-691)
                    rev_comp_comp(compA, nali.text_size)
                    rev_comp_comp(compB, nali.text_size)
                    line1 = 1
                sal = f.sorted.get(compA.name)
                if sal is None:
                    raise ValueError(f"no sorted species: {compA.name}")
                for j in range(len(sal.arr)):
                    if sal.fronts[j] > compA.start + compA.size - 1:
                        continue
                    if sal.ends[j] < compA.start:
                        continue
                    upw = sal.arr[j]
                    pw = upw.ali
                    compa, compb = _pw_comps(pw, compA.name)
                    if (
                        compa.contig != compA.contig
                        or compb.contig != compB.contig
                    ):
                        continue
                    if (
                        compa.strand == "+"
                        and compb.strand != compB.strand
                    ):
                        continue
                    line2 = 0
                    if compa.strand == "-":
                        if compb.strand == compB.strand:
                            continue
                        rc(pw)
                        compa, compb = _pw_comps(pw, compA.name)
                        line2 = 1
                    overbeg = max(compA.start, compa.start)
                    overend = min(
                        compA.start + compA.size,
                        compa.start + compa.size,
                    ) - 1
                    cbeg = pos2col(compA, overbeg)
                    cend = pos2col(compA, overend)
                    beg1 = col2pos_after(compB, cbeg)
                    end1 = col2pos_before(compB, cend)
                    cbeg = pos2col(compa, overbeg)
                    cend = pos2col(compa, overend)
                    beg2 = col2pos_after(compb, cbeg)
                    end2 = col2pos_before(compb, cend)
                    if overlap(beg1, end1, beg2, end2) == 1:
                        upw.used[cbeg : cend + 1] = ord("o")
                    if line2 == 1:
                        rc(pw)
                if line1 == 1:
                    rev_comp_comp(compA, nali.text_size)
                    rev_comp_comp(compB, nali.text_size)
    return 0


def _retrieve_exemplar(sal: SortUAlis, src: str, index: int, pos: int,
                       limit: int) -> int:
    """retrieve_exemplar (align_util.c:760-799)."""
    length = len(sal.arr)
    starts, ends = sal.fronts, sal.ends
    max_remain = 0
    max_index = -1
    comp = next(
        (c for c in sal.arr[index].ali.comps if c.src == src), None
    )
    if comp is not None and starts[index] > limit:
        return -1
    exist = 0
    while index < length:
        comp = next(
            (c for c in sal.arr[index].ali.comps if c.src == src), None
        )
        if comp is None:
            if exist == 0:
                index += 1
                continue
            break
        exist = 1
        if starts[index] > pos:
            break
        if ends[index] < pos:
            index += 1
            continue
        remain = int(ends[index]) - pos + 1
        if remain > max_remain:
            max_remain = remain
            max_index = index
        index += 1
    if max_index == -1 and index != length:
        return index
    return max_index


def find_exemplar(sal: SortUAlis, src: str, beg: int, end: int,
                  start_index: int):
    """Find_Exemplar (align_util.c:801-832): greedy max-extension cover
    of [beg, end] by blocks containing src. Returns (head list,
    new start_index)."""
    index = start_index
    pos = beg
    length = len(sal.arr)
    out: List[UAli] = []
    max_index = -1
    while index < length:
        max_index = _retrieve_exemplar(sal, src, index, pos, end)
        if max_index == -1:
            break
        puali = sal.arr[max_index]
        out.append(puali)
        curr_end = int(sal.ends[max_index])
        if curr_end >= end:
            break
        pos = curr_end + 1
        index = max_index + 1
    if max_index > start_index:
        start_index = max_index
    # thread the C's intrusive next-list for API parity
    for a, b in zip(out, out[1:]):
        a.next = b
    if out:
        out[-1].next = None
    return out, start_index
