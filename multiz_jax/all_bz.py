"""all_bz: generate (and run) all pairwise lastz jobs for a species set.

Port of all_bz.c:46-428: the spec-file mini-language with ``#define``
macros and ``pat : pat`` option rules (all_bz.c:92-182), the per-pair
command builders (all_bz.c:185-267), and the pair enumeration for
tba (D=1) and roast (D=0) modes (all_bz.c:381-424).

Upgrade: where the reference runs its O(N^2) independent
pairwise jobs strictly serially through ``system()`` (SURVEY.md §2.5),
``execute=True`` here dispatches them concurrently over a worker pool,
running the lav2maf / maf_sort / single_cov2 stages in-process (no temp
files, no shell). The command *strings* produced in dry-run mode are
byte-identical to the reference's for golden-testing.
"""

from __future__ import annotations

import io
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

VERSION = 15
NON_NAME = " ()"

BZ_CMD = (
    "blastzWrapper %s %s Y=9000 H=0 %s | lav2maf /dev/stdin %s %s | "
    "maf_sort /dev/stdin %s > %s.%s.orig.maf"
)
BZ_T2_CMD = (
    "blastzWrapper %s %s Y=9000 H=0 T=2 %s | lav2maf /dev/stdin %s %s | "
    "maf_sort /dev/stdin %s > %s.%s.orig.maf"
)
SIN_CMD_PRE = "single_cov2 %s.%s.orig.maf "
SIN_CMD_POST = " > %s.%s.sing.maf"
CLEAN_CMD = (
    "blastz_clean %s %s.%s.orig.maf | maf_sort /dev/stdin %s > "
    "%s.%s.clean.maf"
)
TOAST_CMD = (
    "toast %s %s %s %s %s %s.%s.clean.maf %s.%s.clean.maf %s.%s.clean.maf"
    " | maf_sort /dev/stdin %s > %s.%s.%s"
)
TOAST2_CMD = "chain R=%s %s %s.%s.toast.maf | maf_sort /dev/stdin %s > %s.%s.%s"
TOAST_SUFFIX = "toast.maf"
TOAST2_SUFFIX = "toast2.maf"


class AllBzError(Exception):
    pass


def _is_comment(s: str) -> bool:
    s = s.lstrip()
    return s == "" or (s.startswith("#") and not s.startswith("#define "))


def _spec_lines(text: str) -> List[str]:
    """spec_line (all_bz.c:77-89): backslash-newline continuation."""
    out: List[str] = []
    acc = ""
    for raw in text.splitlines(keepends=True):
        line = acc + raw
        body = line.rstrip("\n")
        if body.endswith("\\"):
            acc = body[:-1] + " "
            continue
        out.append(line)
        acc = ""
    if acc:
        out.append(acc)
    return out


@dataclass
class Specs:
    """Parsed rules: (x pattern, y pattern, options z)."""

    rules: List[tuple] = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "Specs":
        """get_specs (all_bz.c:92-163)."""
        macros = {}
        rules = []
        lines = _spec_lines(text)
        i = 0
        while i < len(lines):
            buf = lines[i]
            i += 1
            if _is_comment(buf):
                continue
            if buf.startswith("#define "):
                m = re.match(r"#define\s+(\S+)[ \t]+(.*)", buf.rstrip("\n"))
                if not m:
                    raise AllBzError(f"bad macro: {buf}")
                macros[m.group(1)] = m.group(2)
                continue
            # " name1 : name2 "
            if ":" not in buf:
                raise AllBzError(f"needs ':' in {buf}")
            left, _, right = buf.partition(":")
            name1 = left.split()[0] if left.split() else ""
            rtoks = right.split()
            if not rtoks:
                raise AllBzError(f"confused by {buf}")
            name2 = rtoks[0]
            # next non-comment line has the options; must start with space
            while i < len(lines) and _is_comment(lines[i]):
                i += 1
            if i >= len(lines):
                raise AllBzError("missing options line")
            opt = lines[i]
            i += 1
            if not opt[:1].isspace():
                raise AllBzError(f"missing space at start of {opt}")
            rules.append(
                (macros.get(name1, name1), macros.get(name2, name2),
                 opt.strip())
            )
        return cls(rules)

    def options(self, name1: str, name2: str) -> str:
        """options (all_bz.c:171-182); match = '*' or substring."""

        def match(s, t):
            return t == "*" or s in t

        parts = [
            z for x, y, z in self.rules
            if (match(name1, x) and match(name2, y))
            or (match(name1, y) and match(name2, x))
        ]
        return " ".join(parts)


def names_from_tree(tree: str) -> List[str]:
    """Name extraction (all_bz.c:360-378): split on " ()" chars."""
    out = []
    for tok in re.split(f"[{re.escape(NON_NAME)}]+", tree):
        if tok:
            out.append(tok)
    return out


@dataclass
class AllBz:
    tree: str
    specs: Specs = field(default_factory=Specs)
    run_bz: int = 2  # b=
    post_proc: int = 1  # A=
    run_tba: int = 1  # D=
    reference: Optional[str] = None  # F=
    annotation_file: str = " "  # T= (stored as "A=<path>")
    min_chain: str = " "  # h=
    min_cluster: str = " "  # q=
    singleton: str = " "  # s=
    inflation: str = ""  # f= (the C's init quirk zeroes this one,
    #                          all_bz.c:302-303)
    close_alignment: str = " "  # c=
    verbose: bool = False
    execute: bool = True
    out = None
    err = None

    def __post_init__(self):
        self.names = names_from_tree(self.tree)
        self._bz_jobs: List[tuple] = []
        self._pp_jobs: List[tuple] = []

    # ---- command builders (byte-identical strings) ----

    def bz_cmd(self, mname: str, nname: str, t2: int) -> Optional[str]:
        buf = self.specs.options(mname, nname)
        if "NOALIGN" in buf:
            return None
        fmt = BZ_T2_CMD if t2 else BZ_CMD
        return fmt % (
            mname, nname, buf, mname, nname, mname, mname, nname
        )

    def pp_cmd(self, mname: str, nname: str) -> Optional[str]:
        buf = self.specs.options(mname, nname)
        if "NOALIGN" in buf:
            return None
        cmd = SIN_CMD_PRE % (mname, nname)
        if self.reference is not None and self.reference in (mname, nname):
            cmd += "R=" + self.reference
        cmd += SIN_CMD_POST % (mname, nname)
        return cmd

    def toast_cmds(self, mname: str, nname: str) -> List[str]:
        cmds = [
            CLEAN_CMD % (
                self.close_alignment, mname, nname, mname, mname, nname
            ),
            TOAST_CMD % (
                self.singleton, self.min_cluster, self.min_chain,
                self.inflation, self.annotation_file, mname, nname,
                mname, mname, nname, nname, mname, mname, nname,
                TOAST_SUFFIX,
            ),
        ]
        if self.post_proc == 2:
            if self.reference is None:
                raise AllBzError("To use A=2, reference must be specified")
            cmds.append(
                TOAST2_CMD % (
                    self.reference, self.inflation, mname, nname, mname,
                    mname, nname, TOAST2_SUFFIX,
                )
            )
        return cmds

    # ---- pair enumeration (all_bz.c:381-424) ----

    def _command_bz(self, mname, nname, t2):
        if self.run_bz == 0:
            return
        cmd = self.bz_cmd(mname, nname, t2)
        if cmd is None:
            if self.verbose:
                self.out.write(f"do not align {mname} and {nname}\n")
            return
        if self.verbose:
            self.out.write(cmd + "\n")
        if self.execute:
            self._bz_jobs.append((mname, nname, t2))

    def _command_pp(self, mname, nname):
        if self.specs.options(mname, nname).find("NOALIGN") >= 0:
            if self.verbose:
                self.out.write(f"do not align {mname} and {nname}\n")
            return
        if self.post_proc == 1:
            cmd = self.pp_cmd(mname, nname)
            if self.verbose:
                self.out.write(cmd + "\n")
            if self.execute:
                self._pp_jobs.append((mname, nname))
        else:
            # toast pipeline: external binaries not shipped with the
            # reference either (chain.h, all_bz.c:50-52) — emit the
            # commands only. Quirk: CLEAN/TOAST print to stderr but the
            # A=2 chain command prints to stdout (all_bz.c:246-257).
            # (Deviation: the reference also system()s CLEAN_CMD even in
            # dry-run mode, all_bz.c:243 — we never execute when
            # execute=False.)
            cmds = self.toast_cmds(mname, nname)
            for i, cmd in enumerate(cmds):
                if self.verbose:
                    (self.out if i == 2 else self.err).write(cmd + "\n")

    def run(self, out=None, err=None) -> int:
        self.out = out or sys.stdout
        self.err = err or sys.stderr
        names = self.names
        if self.run_tba == 0:
            if self.reference is None:
                raise AllBzError(
                    "reference must be specified for running roast and its "
                    "all_bz."
                )
            self._command_bz(self.reference, self.reference, 2)
        for i, m in enumerate(names):
            if self.run_tba == 0:
                if m == self.reference:
                    continue
                self._command_bz(self.reference, m, 0)
                self._command_bz(m, m, 2)
            else:
                rest = names[i:] if self.post_proc == 0 else names[i + 1:]
                for n in rest:
                    self._command_bz(m, n, 2 if m == n else 0)
        if self.execute:
            self._run_bz_jobs()
        if self.run_bz == 1:
            return 0
        for i, m in enumerate(names):
            if self.run_tba == 0:
                if self.reference is None:
                    raise AllBzError(
                        "reference must be specified for running roast and "
                        "its all_bz."
                    )
                if m == self.reference:
                    continue
                self._command_pp(self.reference, m)
            else:
                for n in names[i + 1:]:
                    self._command_pp(m, n)
        if self.execute:
            self._run_pp_jobs()
        return 0

    # ---- in-process concurrent execution ----

    def _run_one_bz(self, mname, nname, t2):
        from .blastz_wrapper import main as bzw_main
        from .cli.lav2maf import main as lav2maf_main
        from .cli.maf_sort import main as maf_sort_main
        import tempfile

        opts = self.specs.options(mname, nname).split()
        extra = ["Y=9000", "H=0"] + (["T=2"] if t2 else []) + opts
        lav = io.StringIO()
        rc = bzw_main([mname, nname, *extra], out=lav)
        if rc != 0:
            raise AllBzError("all_bz BZ quits")
        with tempfile.NamedTemporaryFile(
            "w", suffix=".lav", delete=False
        ) as fh:
            fh.write(lav.getvalue())
            lav_path = fh.name
        maf = io.StringIO()
        rc = lav2maf_main([lav_path, mname, nname], out=maf)
        if rc not in (0, None):
            raise AllBzError("all_bz BZ quits")
        with tempfile.NamedTemporaryFile(
            "w", suffix=".maf", delete=False
        ) as fh:
            fh.write(maf.getvalue())
            maf_path = fh.name
        with open(f"{mname}.{nname}.orig.maf", "w") as outfh:
            rc = maf_sort_main([maf_path, mname], out=outfh)
        if rc not in (0, None):
            raise AllBzError("all_bz BZ quits")

    def _run_one_pp(self, mname, nname):
        from .cli.single_cov2 import main as sc2_main

        argv = [f"{mname}.{nname}.orig.maf"]
        if self.reference is not None and self.reference in (mname, nname):
            argv.append("R=" + self.reference)
        with open(f"{mname}.{nname}.sing.maf", "w") as outfh:
            rc = sc2_main(argv, out=outfh)
        if rc not in (0, None):
            raise AllBzError("all_bz post-process quits")

    def _run_bz_jobs(self):
        if not self._bz_jobs:
            return
        with ThreadPoolExecutor(max_workers=8) as ex:
            for f in [
                ex.submit(self._run_one_bz, *j) for j in self._bz_jobs
            ]:
                f.result()
        self._bz_jobs = []

    def _run_pp_jobs(self):
        if not self._pp_jobs:
            return
        with ThreadPoolExecutor(max_workers=8) as ex:
            for f in [
                ex.submit(self._run_one_pp, *j) for j in self._pp_jobs
            ]:
                f.result()
        self._pp_jobs = []
