"""vmatch-compatible CLI.

Mirrors the reference driver stack (reference src/Vmatch/vmatch.c:43
``callvmatch`` -> parsevm.c option table -> procmatch.c dispatch).
This module grows with the engine layer; currently implemented tasks:

- ``-complete`` exact whole-query matching (+ ``-p`` palindromic)
- filters -l (least length), -evalue, -identity, -leastscore
- output controls -absolute, -nodist, -noevalue, -noscore,
  -noidentity, -s (alignment display WIP)

Usage: python -m vstree_tpu.cli.vmatch -complete -q q.fna idx
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.chardef import WILDCARD
from ..core.multiseq import read_multiseq, reverse_complement_inplace
from ..engine.approx import approx_complete_matches
from ..engine.complete import exact_complete_matches
from ..engine.funnel import MatchParams, process_final
from ..engine.match import (
    FLAGPALINDROMIC,
    FLAGQUERY,
    FLAGSELFPALINDROMIC,
    MatchTable,
)
from ..engine.gextend import (
    Seqs,
    edit_extend_seeds,
    hamming_extend_seeds,
)
from ..engine.query import find_query_matches
from ..engine.repeats import find_maximal_pairs_ref
from ..engine.tandem import find_tandems_ref
from ..engine.xdrop import xdrop_extend_seeds
from ..engine.supermax import find_supermax
from ..index.io import read_index
from ..engine.match import FLAGPALINDROMIC as _FLAGPAL
from ..postprocess.select import (
    SORTMODES,
    remove_contained,
    sort_matches,
)
from ..output.render import (
    SHOWABSOLUTE,
    SHOWNODIST,
    SHOWNOEVALUE,
    SHOWNOIDENTITY,
    SHOWNOSCORE,
    argument_header,
    assign_query_digits,
    assign_virtual_digits,
    basic_args,
    render_matches,
)
from ..stats.evalues import Evalues


def parse_args(argv: list[str]) -> dict:
    opts: dict = {
        "index": None, "q": [], "complete": False, "online": False,
        "removeredundant": False, "vplugin": None,
        "l": None, "h": None, "e": None, "p": False, "d": False,
        "absolute": False, "nodist": False, "noevalue": False,
        "noscore": False, "noidentity": False, "best": None,
        "evalue": None, "identity": None, "leastscore": None,
        "supermax": False, "mum": False, "tandem": False, "i": False,
        "v": False, "s": None, "sort": None, "showdesc": None,
        "qspeedup": None,
        "f": False, "selfun": None, "numproc": None,
        "allmax": False, "lowergap": None, "uppergap": None,
        "dnavsprot": None, "dnavsprot_smap": None,
        "args": argv[:],
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            opts["index"] = a
            i += 1
            continue
        key = a[1:]
        if key == "dnavsprot":
            # -dnavsprot transnum [symbolmap] (parsevm.c:1284-1298)
            i += 1
            if i >= len(argv):
                raise SystemExit(
                    "vmatch: missing argument for option -dnavsprot")
            opts["dnavsprot"] = int(argv[i]); i += 1
            from ..core.codon import check_transnum

            try:
                check_transnum(opts["dnavsprot"])
            except ValueError as e:
                raise SystemExit(f"vmatch: {e}")
            if i < len(argv) - 1 and not argv[i].startswith("-"):
                opts["dnavsprot_smap"] = argv[i]; i += 1
            continue
        if key == "q":
            i += 1
            while i < len(argv) and not argv[i].startswith("-") and i < len(argv) - 1:
                opts["q"].append(argv[i]); i += 1
            continue
        if key == "complete":
            # optional argument (parsevm.c:1140-1178): the keyword
            # "removeredundant" or a vmotif*/cpridx* plugin
            opts["complete"] = True
            i += 1
            if i < len(argv) - 1 and not argv[i].startswith("-"):
                arg = argv[i]
                from ..engine.vplugin import is_vplugin_arg

                if arg == "remred":
                    opts["removeredundant"] = True; i += 1
                elif is_vplugin_arg(arg):
                    opts["vplugin"] = arg; i += 1
                elif "." not in arg and arg != opts.get("index"):
                    raise SystemExit(
                        'vmatch: argument to option -complete must be '
                        'either the keyword "remred" or names of '
                        'shared object files with prefix "vmotif" or '
                        '"cpridxps"')
            continue
        if key in ("online", "p", "d", "absolute", "nodist",
                   "noevalue", "noscore", "noidentity", "supermax",
                   "tandem", "i", "v", "allmax"):
            opts[key] = True; i += 1; continue
        if key == "mum":
            opts["mum"] = True
            if i + 1 < len(argv) and argv[i + 1] == "cand":
                opts["mumcand"] = True; i += 1
            i += 1; continue
        if key == "qspeedup":
            i += 1
            if i >= len(argv) - 1 or not _is_number(argv[i]):
                raise SystemExit(
                    "vmatch: argument of option -qspeedup must be "
                    "non-negative integer")
            opts["qspeedup"] = int(argv[i]); i += 1
            continue
        if key in ("l", "best", "seedlength"):
            # optional numeric argument(s)
            if i + 1 < len(argv) and _is_number(argv[i + 1]):
                opts[key] = int(argv[i + 1]); i += 1
            else:
                opts[key] = 0
            if key == "l":
                # optional lower/upper gap bounds
                # (parselowerupperbounds, parsevm.c:536-585)
                if i + 1 < len(argv) - 1 and _is_number(argv[i + 1]):
                    i += 1
                    lower = int(argv[i])
                    if lower < 0 and -lower > (opts["l"] or 0):
                        raise SystemExit(
                            "vmatch: if second argument is negative, "
                            "the absolute value must not be larger "
                            "than the user defined leastlength")
                    opts["lowergap"] = lower
                    if i + 1 < len(argv) - 1                             and _is_number(argv[i + 1]):
                        i += 1
                        upper = int(argv[i])
                        if upper < lower:
                            raise SystemExit(
                                f'vmatch: optional second argument '
                                f'"{upper}" of option -l must be '
                                f'greater or equal than first '
                                f'argument "{lower}"')
                        opts["uppergap"] = upper
            i += 1; continue
        if key in ("h", "e", "exdrop", "hxdrop", "leastscore",
                   "identity", "numproc"):
            i += 1
            opts[key] = int(argv[i]); i += 1; continue
        if key == "evalue":
            i += 1
            opts["evalue"] = float(argv[i]); i += 1; continue
        if key in ("dbnomatch", "qnomatch"):
            # -dbnomatch/-qnomatch N [keepflag] (parsevm.c:1023-1045)
            i += 1
            opts["nomatch"] = int(argv[i]); i += 1
            opts["nomatch_markdb"] = key == "dbnomatch"
            if key == "dbnomatch" and i < len(argv) - 1 \
                    and argv[i] in _KEEPFLAGS:
                opts["nomatch_keep"] = argv[i]; i += 1
            continue
        if key in ("dbmaskmatch", "qmaskmatch"):
            # -dbmaskmatch/-qmaskmatch <char>|tolower|toupper
            # [keepflag] (parsevm.c:1046-1074)
            i += 1
            arg = argv[i]; i += 1
            if arg not in ("tolower", "toupper") and len(arg) != 1:
                raise SystemExit(
                    f'vmatch: illegal argument "{arg}" to option '
                    f"-{key}: must be single character or the "
                    'keywords "toupper" or "tolower"'
                )
            opts["maskchar"] = arg
            opts["mask_markdb"] = key == "dbmaskmatch"
            if key == "dbmaskmatch" and i < len(argv) - 1 \
                    and argv[i] in _KEEPFLAGS:
                opts["mask_keep"] = argv[i]; i += 1
            continue
        if key == "s":
            # parsesequenceoutparms (Vmatch/optstring.c:62-108): up to
            # two optional args: a line width and/or a display keyword
            from ..output import align as _al

            showstring = _al.DEFAULTLINEWIDTH
            nopt = 0
            while (nopt < 2 and i + 1 < len(argv) - 1
                   and not argv[i + 1].startswith("-")):
                ret = _parse_s_arg(argv[i + 1])
                if ret & _al.MAXLINEWIDTH:
                    if nopt == 0:
                        showstring = ret
                    else:
                        showstring = (
                            showstring
                            & (_al.SHOWPURELEFTSEQ | _al.SHOWPURERIGHTSEQ)
                        ) | ret
                else:
                    showstring |= ret
                i += 1
                nopt += 1
            opts["s"] = showstring
            i += 1; continue
        if key == "pp":
            # -pp chain|matchcluster <operands...> (parsepp.c:123-186):
            # operands run until the next option or the trailing index
            # argument; known sub-option keywords get a "-" prefix
            # (filltransformedargs, parsepp.c:32-94)
            j = i + 1
            ops: list[str] = []
            while j < len(argv) - 1 and not argv[j].startswith("-"):
                ops.append(argv[j]); j += 1
            if not ops:
                raise SystemExit(
                    "vmatch: missing argument for option -pp")
            ppmode, rest = ops[0], ops[1:]
            if ppmode == "chain":
                kw = ("global", "local", "maxgap", "outprefix",
                      "silent", "thread", "wf", "withinborders")
                targs = [("-" + a if a in kw else a) for a in rest]
                from .chain2dim import parse_chain_args

                cmode, _, _ = parse_chain_args(targs + ["dummyindex"])
                opts["pp_chain"] = cmode
            elif ppmode == "matchcluster":
                kw = ("erate", "gapsize", "overlap", "outprefix")
                targs = [("-" + a if a in kw else a) for a in rest]
                from .matchcluster import parse_matchcluster_args

                info, _ = parse_matchcluster_args(targs,
                                                  fromvmatch=True)
                opts["pp_mcl"] = info
            else:
                raise SystemExit(
                    f'vmatch: illegal postprocessing mode "{ppmode}"')
            i = j
            continue
        if key == "dbcluster":
            # -dbcluster p1 p2 [prefix [(min,max)]]
            # (parsedbcl.c:16-75)
            from ..postprocess.dbcluster import Clusterparms

            parms = Clusterparms()
            for which in ("first", "second"):
                i += 1
                if i >= len(argv) or argv[i].startswith("-"):
                    raise SystemExit(
                        "vmatch: missing argument for option "
                        "-dbcluster")
                v = int(argv[i])
                if v < 0 or v > 100:
                    raise SystemExit(
                        f"vmatch: {which} argument to option "
                        f"-dbcluster must be integer in range [0,100]")
                if which == "first":
                    parms.percsmall = v
                else:
                    parms.perclarge = v
            if i + 1 < len(argv) - 1 and not argv[i + 1].startswith("-"):
                i += 1
                if argv[i].startswith("("):
                    raise SystemExit(
                        "vmatch: the specification of minimal and "
                        "maximal cluster sizes requires the "
                        "specification of a file prefix as third "
                        "argument")
                parms.prefix = argv[i]
                if i + 1 < len(argv) - 1 \
                        and not argv[i + 1].startswith("-"):
                    i += 1
                    import re

                    m = re.fullmatch(r"\((\d+),(\d+)\)", argv[i])
                    if not m:
                        raise SystemExit(
                            f'vmatch: incorrect fourth argument '
                            f'"{argv[i]}" to option -dbcluster: '
                            "cluster size specification must be of "
                            "the form (dbclminsize,dbclmaxsize)")
                    parms.minsize = int(m.group(1))
                    parms.maxsize = int(m.group(2))
                    if parms.minsize < 1:
                        raise SystemExit(
                            "vmatch: first number in clustersize "
                            "specification must not be < 1")
                    if parms.maxsize != 0 \
                            and parms.maxsize < parms.minsize:
                        raise SystemExit(
                            "vmatch: second number in clustersize "
                            "specification must not be smaller than "
                            "first number")
            opts["dbcluster"] = parms
            i += 1
            continue
        if key == "nonredundant":
            i += 1
            if i >= len(argv) - 1 or argv[i].startswith("-"):
                raise SystemExit(
                    "vmatch: missing argument for option -nonredundant")
            opts["nonredundant"] = argv[i]
            i += 1
            continue
        if key == "f":
            # -f: show filename where match occurs (parsevm.c:833-834,
            # SHOWFILE)
            opts["f"] = True; i += 1; continue
        if key == "showdesc":
            # parsedescparameters (parsevm.c:587-620): one mandatory
            # argument: maxlength or (skipprefix,maxlength)
            import re as _re

            if i + 1 >= len(argv) - 1:
                raise SystemExit(
                    "vmatch: missing argument for option -showdesc")
            i += 1
            arg = argv[i]
            sd = {"skipprefix": 0, "maxlength": 0,
                  "untilfirstblank": False, "replaceblanks": True}
            m = _re.fullmatch(r"\((\d+),(\d+)\)", arg)
            if m:
                sd["skipprefix"] = int(m.group(1))
                sd["maxlength"] = int(m.group(2))
            elif _re.fullmatch(r"\d+", arg):
                sd["maxlength"] = int(arg)
            else:
                raise SystemExit(
                    f'vmatch: incorrect argument "{arg}" to option '
                    "-showdesc: must be either single number or pair "
                    "(skipprefix,maxlength) of non-negative integers")
            if sd["maxlength"] == 0:
                sd["untilfirstblank"] = True
            opts["showdesc"] = sd
            i += 1; continue
        if key == "selfun":
            # -selfun <module.py> [args...]: Python selection-function
            # module implementing the select.h:41-50 hook protocol
            if i + 1 >= len(argv) - 1:
                raise SystemExit(
                    "vmatch: missing argument for option -selfun")
            i += 1
            opts["selfun"] = argv[i]
            i += 1
            sargs = []
            while i < len(argv) - 1 and not argv[i].startswith("-"):
                sargs.append(argv[i]); i += 1
            opts["selfun_args"] = sargs
            continue
        if key == "sort":
            if i + 1 < len(argv) and not argv[i + 1].startswith("-") \
                    and i + 1 < len(argv) - 1:
                opts[key] = argv[i + 1]; i += 1
            else:
                opts[key] = ""
            i += 1; continue
        if key in ("dbms", "mysql"):
            # compile-gated VMATCHDB SQL export (Vmatch/vmdbfunc.c,
            # OFF in the shipped Makefile, Vmatch/Makefile:3-4)
            raise SystemExit(
                "vmatch: option -dbms is not supported: the database "
                "export is compile-gated OFF in the reference "
                "(VMATCHDB, Vmatch/Makefile:3-4) and deliberately "
                "excluded here; see the capability matrix in README")
        if key in ("regexp", "agrep"):
            # WITHREGEXP / WITHAGREP need external automata libraries
            # (fcomplete.c:17-24) and are OFF in the shipped build
            raise SystemExit(
                f"vmatch: option -{key} is not supported: it needs "
                "the external libautomata build (fcomplete.c:17-24, "
                "OFF in the shipped reference); deliberately excluded "
                "here; see the capability matrix in README")
        if key in ("pssm", "vplugin", "vmotif", "cpridx"):
            # vendored lib-homann PSSM search / the vplugin ABI
            raise SystemExit(
                f"vmatch: option -{key} is not supported: the "
                "PSSM/vplugin search ships as vendored tarballs in "
                "the reference (lib-homann/) and is deliberately "
                "excluded here; see the capability matrix in README")
        raise SystemExit(f"vmatch: illegal option {a}")
    if opts["index"] is None:
        raise SystemExit("vmatch: the last argument must be the index name")
    _parse_constraints(opts)
    return opts


def _parse_constraints(opts) -> None:
    """Declarative parse-time constraints via the shared combinator
    table (core/optdesc.py — the reference's OPTIONEXCLUDE/IMPLY
    discipline, procopt.c:505-583).  Constraints the reference
    enforces DEEPER than parse (after the header print, or inside the
    engines) stay at their original sites so message order matches;
    new rules should land here."""
    from ..core.optdesc import Constraints

    c = Constraints("vmatch")
    # -complete remred (parsevm.c:1433-1454); "complete" is mapped to
    # the remred argument below so the message names -complete
    c.imply("complete", "online", argument="remred")
    if opts["removeredundant"] and opts["online"] \
            and opts["e"] is None and opts["h"] is None:
        raise SystemExit(
            'vmatch: argument "remred" of option -complete '
            "requires options -e or -h")

    def isset(name):
        if name == "complete":
            return bool(opts["removeredundant"])
        v = opts.get(name)
        if v is None or isinstance(v, bool):
            return bool(v)
        if isinstance(v, (list, str)):
            return bool(v)
        return True    # numeric option present
    c.check(isset)


_KEEPFLAGS = (
    "keepleft", "keepright", "keepleftifsamesequence",
    "keeprightifsamesequence",
)


def _parse_s_arg(arg: str) -> int:
    """parseoptstringargs (Vmatch/optstring.c:15-56)."""
    from ..output import align as _al

    if arg[:1].isdigit():
        try:
            v = int(arg)
        except ValueError:
            v = 0
        if not (0 < v <= _al.MAXLINEWIDTH):
            raise SystemExit(
                f'vmatch: argument "{arg}" of option -s must be number '
                f"in the range [1...{_al.MAXLINEWIDTH}]"
            )
        return v
    kw = {
        "leftseq": _al.SHOWPURELEFTSEQ,
        "rightseq": _al.SHOWPURERIGHTSEQ,
        "abbrev": _al.SHOWALIGNABBREV,
        "abbreviub": _al.SHOWALIGNABBREVIUB,
        "xml": _al.SHOWVMATCHXML,
    }
    if arg in kw:
        return kw[arg]
    raise SystemExit(
        f'vmatch: incorrect argument "{arg}" to option -s '
        "must be one of the following keywords: "
        "leftseq, rightseq, abbrev, abbreviub"
    )


def _is_number(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    from ..core.envconf import configure_compile_cache

    configure_compile_cache()
    opts = parse_args(argv)
    # queryspeedup: option, overridden by env QUERYSPEEDUP
    # (parsevm.c:1126-1137,1642); algorithms 0, 2 (the default) and 5
    # are reproduced probe-exactly; 1 is rejected with the reference's
    # own message, 3 crashes the reference (not supported here), 4
    # demands the experimental lsf table that no builder emits
    import os as _os

    qsp = opts["qspeedup"] if opts["qspeedup"] is not None else 2
    _qe = _os.environ.get("QUERYSPEEDUP")
    if _qe is not None:
        try:
            qsp = int(_qe)
            if qsp < 0:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f'vmatch: incorrect value "{_qe}" of environment '
                "variable QUERYSPEEDUP; must be non-negative integer")
    if qsp == 1:
        raise SystemExit(
            "vmatch: Algorithm 1 is no longer available, please use "
            "Algorithm 0, or 2; we recommend Algorithm 2")
    if qsp > 5:
        raise SystemExit(f"vmatch: illegal speedup value {qsp}")
    if qsp == 3:
        # the reference binary crashes on -qspeedup 3 (matchsub.c:539
        # walks an inconsistent sti1 state); refuse explicitly
        raise SystemExit(
            "vmatch: Algorithm 3 is not supported (it crashes the "
            "reference implementation); please use Algorithm 0, 2 "
            "or 5")
    if qsp == 4:
        # Algorithm 4 demands the lsf table — which the reference's
        # own reader rejects even when built by its own mklsf
        # (2(n+1) bytes written vs 2n+1 expected, readvirt.c:895), so
        # the algorithm is unusable in the shipped reference; our
        # cli/mklsf reproduces the table bytes regardless
        raise SystemExit(
            "vmatch: Algorithm 4 is not supported: the reference's "
            "own reader rejects its mklsf output (size mismatch, "
            "readvirt.c:895), making it unusable there; please use "
            "Algorithm 0, 2 or 5")
    esa = read_index(opts["index"])
    # -numproc N (parsevm.c:877, vdfstrav.c:419-499 DISTRIBUTEDDFS):
    # distribute the rank range over N devices of a jax mesh
    mesh = None
    if opts["numproc"] and opts["numproc"] > 1:
        from ..parallel.shardesa import numproc_mesh

        mesh = numproc_mesh(opts["numproc"])
    ms = esa.multiseq
    ev = Evalues(1.0 / esa.alpha.num_regular)
    mp = MatchParams(
        leastlength=opts["l"] or 0,
        identity=opts["identity"] or 0.0,
        leastscore=opts["leastscore"],
        maxevalue=opts["evalue"],
        lowergaplength=opts["lowergap"],
        uppergaplength=opts["uppergap"],
    )
    if opts["i"] and opts["absolute"]:
        raise SystemExit(
            "vmatch: option -i and option -absolute exclude each "
            "other")
    if opts["allmax"] and opts["best"] is not None:
        raise SystemExit(
            "vmatch: option -allmax and option -best exclude each "
            "other")
    if opts["allmax"] and opts["sort"] is not None:
        raise SystemExit(
            "vmatch: option -sort and option -allmax exclude each "
            "other")
    if opts["allmax"] and opts.get("h") is None \
            and opts.get("e") is None:
        # OPTIONIMPLYEITHER2(OPTALLMAX,OPTHDIST,OPTEDIST)
        raise SystemExit(
            "vmatch: option -allmax requires either option -h or -e")
    showmode = 0
    if opts["absolute"]:
        showmode |= SHOWABSOLUTE
    if opts["f"]:
        from ..output.render import SHOWFILE

        showmode |= SHOWFILE
    if opts["nodist"]:
        showmode |= SHOWNODIST
    if opts["noevalue"]:
        showmode |= SHOWNOEVALUE
    if opts["noscore"]:
        showmode |= SHOWNOSCORE
    if opts["noidentity"]:
        showmode |= SHOWNOIDENTITY

    hooks = None
    if opts["selfun"] is not None:
        # Python analog of the dlopen selection-function plugin
        # (reference Vmatch/opensel.c + include/select.h:41-50): the
        # module may define selectmatch_header/init/match/wrap/
        # final_table
        import importlib.util

        from ..engine.funnel import SelectionHooks

        spec = importlib.util.spec_from_file_location(
            "vmatch_selfun", opts["selfun"])
        if spec is None or spec.loader is None:
            raise SystemExit(
                f"vmatch: cannot load selection module "
                f"{opts['selfun']!r}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        hooks = SelectionHooks(
            header=getattr(module, "selectmatch_header", None),
            init=getattr(module, "selectmatch_init", None),
            match=getattr(module, "selectmatch", None),
            wrap=getattr(module, "selectmatch_wrap", None),
            final_table=getattr(module, "selectmatch_finaltable", None),
        )
        if hooks.header is not None:
            hooks.header(argv, opts.get("selfun_args", []))
        if hooks.init is not None:
            hooks.init(esa.alpha, ms, None)

    from ..output import align as _al

    xmlmode = opts["s"] is not None and bool(
        opts["s"] & _al.SHOWVMATCHXML)
    if opts.get("maskchar") is None:
        # masking mode replaces the match funnel output entirely,
        # including the argument header (initpost.c markermaskmatchout)
        if xmlmode:
            from ..output.xml import xml_header

            xml_header(argv, out)
        else:
            print(argument_header(argv[:-1], opts["index"]), file=out)

    digits = assign_virtual_digits(ms)

    if opts["sort"] is not None and opts["best"] is None:
        raise SystemExit("vmatch: option -sort requires option -best")
    if opts.get("nonredundant") is not None \
            and opts.get("dbcluster") is None:
        raise SystemExit(
            "vmatch: option -nonredundant requires option -dbcluster")

    def _mark_and_emit(mt, query):
        """-dbnomatch/-qnomatch/-dbmaskmatch/-qmaskmatch output path
        (initpost.c:25-269, markmat.c, nomatch.c, showmasked.c)."""
        from ..postprocess.mask import (
            Markfields,
            init_marktable,
            mark_matches,
            show_masked_seq,
            show_nomatch,
        )

        nomatch = opts.get("nomatch")
        mf = Markfields(
            markdb=opts.get(
                "nomatch_markdb" if nomatch is not None else "mask_markdb",
                True,
            )
        )
        keep = opts.get(
            "nomatch_keep" if nomatch is not None else "mask_keep"
        )
        if keep:
            mf.parse_keepflag(
                keep,
                "-dbnomatch" if nomatch is not None else "-dbmaskmatch",
            )
        selfmatch = not opts["q"]
        iscomplete = bool(opts["complete"])
        has_iq2 = ms.numofquerysequences > 0
        # DATABASELENGTH macro subtracts the separator slot
        # unconditionally (multidef.h:91-92)
        dblen_ref = ms.totallength - ms.totalquerylength - 1
        if selfmatch:
            if not mf.markdb and not has_iq2:
                which = "-qnomatch" if nomatch is not None \
                    else "-qmaskmatch"
                raise SystemExit(
                    f"vmatch: option {which} requires index containing "
                    "query sequences or option -q"
                )
            msmark = ms
        else:
            msmark = ms if (iscomplete or mf.markdb) else query
        bits = init_marktable(msmark)
        mark_matches(
            bits, mt, mf,
            has_no_query_files=selfmatch,
            vms_has_indexed_queries=has_iq2,
            database_length=dblen_ref,
        )
        if nomatch is not None:
            if selfmatch:
                if mf.markdb:
                    posoffset, length = 0, dblen_ref
                else:
                    posoffset = dblen_ref + 1
                    length = ms.totalquerylength
                msref = ms
            else:
                msref = msmark
                posoffset, length = 0, msref.totallength
            show_nomatch(bits, msref, posoffset, length, nomatch,
                         absolute=opts["absolute"], out=out)
        else:
            if mf.markdb:
                show_masked_seq(ms, bits, opts["maskchar"], out=out)
            else:
                if selfmatch:
                    raise SystemExit(
                        "vmatch: maskmatch for query sequence in "
                        "index not implemented"
                    )
                chars = bytes(esa.alpha.characters) \
                    if msmark.originalsequence is None else None
                show_masked_seq(msmark, bits, opts["maskchar"],
                                characters=chars, out=out)
        return 0

    def finish(mt, query=None, raw=None):
        """preinfo (-i), best-k (-best [+ -sort]), render."""
        if opts.get("nomatch") is not None or \
                opts.get("maskchar") is not None:
            return _mark_and_emit(mt, query)
        if opts.get("dbcluster") is not None:
            from ..postprocess.dbcluster import run_dbcluster

            parms = opts["dbcluster"]
            parms.nonredundantfile = opts.get("nonredundant")
            run_dbcluster(
                ms, mt, parms,
                basic_header=argument_header(
                    basic_args(argv[:-1]), opts["index"]),
                digits=digits, showmode=showmode,
                showdesc_defined=opts["showdesc"] is not None,
                showstring=opts["s"] or 0, out=out,
            )
            return 0
        if opts.get("pp_chain") is not None:
            from ..postprocess.chain import vmatch_chaining

            def emit_rows(sub, fh):
                for line in render_matches(sub, ms, digits, showmode,
                                           query):
                    fh.write(line + "\n")

            vmatch_chaining(
                mt, opts["pp_chain"],
                argument_header(basic_args(argv[:-1]), opts["index"]),
                emit_rows, out,
            )
            return 0
        if opts.get("pp_mcl") is not None:
            from ..postprocess.matchcluster import run_matchcluster

            mfargs = argument_header(
                basic_args(argv[:-1]), opts["index"]
            )[len("# args="):]
            run_matchcluster(opts["pp_mcl"], mt, ms, query, mfargs,
                             out=out)
            return 0
        if opts["i"]:
            # match-count distribution (vmatcount.c via distri.c):
            # histogram of match lengths, engine output pre-filter
            lens = (raw if raw is not None else mt).length1
            print(f"# all {lens.size}", file=out)
            for ln in np.unique(lens):
                print(f"# {ln} {int((lens == ln).sum())}", file=out)
            return 0
        if opts["best"] is not None:
            # bestmatch.c cmpBestMatch order: Evalue asc, length1
            # desc, position1 asc, length2 desc, position2 asc,
            # direct before palindromic
            pal = ((mt.flag & _FLAGPAL) != 0).astype(np.int64)
            order = np.lexsort((
                pal, mt.position2, -mt.length2, mt.position1,
                -mt.length1, mt.evalue,
            ))
            mt = mt.select(order[: opts["best"]])
            if opts["sort"] is not None:
                # showbestmatchlist (procfinal.c:720-735): contained
                # matches removed first; mode "ia" keeps the
                # removecontained order
                if opts["sort"] not in SORTMODES:
                    raise SystemExit(
                        f"vmatch: illegal sort mode {opts['sort']!r}")
                mt, _ = remove_contained(mt)
                if opts["sort"] != "ia":
                    mt = sort_matches(mt, opts["sort"])
        if hooks is not None and hooks.final_table is not None:
            mt = hooks.final_table(mt) or mt
        if xmlmode:
            # -s xml (xmlfunc.c + echomatch.c:1036-1045)
            from ..output.align import alignment_eops
            from ..output.render import format_description
            from ..output.xml import xml_init, xml_match, xml_wrap

            xml_init(esa.alpha, ms, query, out)
            modes = mt.mode_chars()
            scores = mt.score
            idents = mt.identity
            sd = opts["showdesc"]
            if sd is not None:
                sd = dict(sd, replaceblanks=False)
            for k in range(len(mt)):
                row = {
                    "position1": int(mt.position1[k]),
                    "length1": int(mt.length1[k]),
                    "position2": int(mt.position2[k]),
                    "length2": int(mt.length2[k]),
                    "distance": int(mt.distance[k]),
                    "flag": int(mt.flag[k]),
                    "seqnum1": int(mt.seqnum1[k]),
                    "relpos1": int(mt.relpos1[k]),
                    "seqnum2": int(mt.seqnum2[k]),
                    "relpos2": int(mt.relpos2[k]),
                    "evalue": float(mt.evalue[k]),
                    "score": int(scores[k]),
                    "identity": float(idents[k]),
                    "idnumber": int(mt.idnumber[k]),
                    "xdropscore": xdrop,
                }
                eops = alignment_eops(row, ms, query)
                d1 = d2 = None
                if sd is not None:
                    d1 = format_description(ms, row["seqnum1"], sd)
                    dms = query if query is not None else ms
                    d2 = format_description(dms, row["seqnum2"], sd)
                xml_match(row, modes[k], eops, out, d1, d2)
            xml_wrap(out)
            return 0
        lines = render_matches(mt, ms, digits, showmode, query,
                               showdesc=opts["showdesc"])
        if hooks is not None and hooks.wrap is not None:
            hooks.wrap(esa.alpha, ms, query)
        if opts["s"] is not None:
            # echomatch2file with showstring > 0 (echomatch.c:1036-1086):
            # row, newline, alignment text, newline
            from ..output.align import echo_string_output

            for k, line in enumerate(lines):
                out.write(line + "\n")
                row = {
                    "position1": int(mt.position1[k]),
                    "length1": int(mt.length1[k]),
                    "position2": int(mt.position2[k]),
                    "length2": int(mt.length2[k]),
                    "distance": int(mt.distance[k]),
                    "flag": int(mt.flag[k]),
                    "relpos1": int(mt.relpos1[k]),
                    "relpos2": int(mt.relpos2[k]),
                    "xdropscore": xdrop,
                }
                out.write(echo_string_output(row, ms, query, opts["s"]))
                out.write("\n")
            return 0
        for line in lines:
            print(line, file=out)
        return 0

    # -exdrop/-hxdrop: reference stores -hxdrop negated
    # (parsevm.c:974-992); seedlength defaults to 30 for xdrop tasks
    # (matchlenparm.c:4,40-44)
    xdrop = None
    if opts.get("exdrop") is not None:
        xdrop = opts["exdrop"]
    elif opts.get("hxdrop") is not None:
        xdrop = -opts["hxdrop"]

    has_iq = ms.numofquerysequences > 0

    def _cross_filter(mt):
        """CHECKEXCLUSION (fself.c:33-36): on an index with indexed
        queries, keep only self pairs straddling the db/query
        separator."""
        if not has_iq or len(mt) == 0:
            return mt
        qsep = ms.database_length
        return mt.select(
            (mt.position1 < qsep) & (mt.position2 > qsep)
        )

    if opts["complete"] and opts["vplugin"] is not None:
        # vplugin takeover (vplugin-interface.h:37-52 analog): the
        # plugin owns the whole search — with or without -q — and its
        # emitted tables run through the standard funnel/output
        from ..engine.vplugin import VpluginData, run_vplugin

        vquery = (read_multiseq(opts["q"], esa.alpha,
                                store_original=True)
                  if opts["q"] else None)

        def vp_process(mt):
            raw = mt
            out_mt = process_final(mt, ms, ev, mp, query=vquery,
                                   selection=hooks)
            finish(out_mt, query=vquery, raw=raw)

        data = VpluginData(
            progname="vmatch",
            indexname=opts["index"],
            esa=esa,
            queryfiles=list(opts["q"]),
            query=vquery,
            forceonline=bool(opts["online"]),
            plugin_args=list(opts.get("selfun_args") or []),
            process=vp_process,
        )
        run_vplugin(opts["vplugin"], data)
        return 0

    if not opts["q"]:
        # self-match tasks
        if opts["supermax"]:
            if opts["l"] is None:
                raise SystemExit(
                    "vmatch: option -supermax requires option -l"
                )
            if has_iq:
                raise SystemExit(
                    "vmatch: supermaximal repeat search does not "
                    "allow query files in index"
                )
            raw = find_supermax(esa, opts["l"], mesh=mesh)
            mt = process_final(raw, ms, ev, mp, selection=hooks)
            return finish(mt, raw=raw)
        if opts["tandem"]:
            if opts["l"] is None:
                raise SystemExit(
                    "vmatch: option -tandem requires option -l"
                )
            if has_iq:
                raise SystemExit(
                    "vmatch: tandem repeat search does not allow "
                    "query files in index"
                )
            raw = find_tandems_ref(esa, opts["l"])
            mt = process_final(raw, ms, ev, mp, selection=hooks)
            return finish(mt, raw=raw)
        if opts["mum"]:
            # self variant: maximal unique matches between the
            # database and indexed-query regions (fmumself.c)
            if opts.get("mumcand"):
                raise SystemExit(
                    "vmatch: option -mum cand also requires option -q"
                )
            if opts["l"] is None:
                raise SystemExit(
                    "vmatch: option -mum requires option -l"
                )
            from ..engine.mumself import find_mum_self

            raw = find_mum_self(esa, opts["l"])
            mt = process_final(raw, ms, ev, mp, selection=hooks)
            return finish(mt, raw=raw)
        if opts["l"] is not None or xdrop is not None:
            k_h = opts.get("h")
            k_e = opts.get("e")
            tables = []
            if not (opts["d"] or not opts["p"]):
                mt = MatchTable()
            elif xdrop is not None:
                # x-drop seed extension (fself.c:157-173 ->
                # xdropseedextend); seeds are maximal pairs of length
                # >= seedlength (default 30)
                seedlength = opts.get("seedlength") or 30
                seeds = _cross_filter(find_maximal_pairs_ref(esa, seedlength))
                sq = Seqs(ms.sequence, ms.sequence)
                mt = xdrop_extend_seeds(sq, seeds, xdrop, seedlength,
                                        querycompare=False)
            elif k_h is not None or k_e is not None:
                # approximate repeats: exact seeds + greedy extension
                # (fself.c:95 -> extendgen.c callgenericextend)
                k = k_e if k_e is not None else k_h
                seedlength = max(opts.get("seedlength") or 0,
                                 opts["l"] // (k + 1))
                sq = Seqs(ms.sequence, ms.sequence)
                mt = None
                if k_e is not None and not has_iq:
                    # fused device path: seeds never leave the device
                    from ..engine.gextend import (
                        edit_extend_self_device,
                    )

                    mt = edit_extend_self_device(
                        esa, sq, ev, k, opts["l"], seedlength,
                        allmax=opts["allmax"])
                if mt is None:
                    seeds = _cross_filter(
                        find_maximal_pairs_ref(esa, seedlength))
                    if k_e is not None:
                        mt = edit_extend_seeds(
                            sq, ev, seeds, k, opts["l"], seedlength,
                            querycompare=False, selfmode=True,
                            allmax=opts["allmax"])
                    else:
                        mt = hamming_extend_seeds(
                            sq, ev, seeds, k, opts["l"], seedlength,
                            querycompare=False,
                            allmax=opts["allmax"])
            else:
                mt = _cross_filter(find_maximal_pairs_ref(esa, opts["l"]))
            tables.append(mt)
            if opts["p"]:
                # self palindromic comparison (runself.c:128-180
                # runselfmatchespalindromic): the db matched against
                # its own per-sequence reverse complement through the
                # query machinery, flagged FLAGSELFPALINDROMIC
                if has_iq:
                    raise SystemExit(
                        "vmatch: option -p for self comparison does "
                        "not allow queryfiles in the index")
                qrc = reverse_complement_inplace(ms)
                spflags = FLAGPALINDROMIC | FLAGSELFPALINDROMIC
                k = k_e if k_e is not None else k_h
                if xdrop is not None:
                    seedlength = opts.get("seedlength") or 30
                    seeds = find_query_matches(
                        esa, qrc, seedlength, "mem",
                        flags_extra=spflags, qspeedup=qsp)
                    sq = Seqs(ms.sequence, qrc.sequence)
                    pmt = xdrop_extend_seeds(
                        sq, seeds, xdrop, seedlength,
                        querycompare=True)
                elif k is not None:
                    seedlength = max(opts.get("seedlength") or 0,
                                     opts["l"] // (k + 1))
                    seeds = find_query_matches(
                        esa, qrc, seedlength, "mem",
                        flags_extra=spflags, qspeedup=qsp)
                    sq = Seqs(ms.sequence, qrc.sequence)
                    if k_e is not None:
                        pmt = edit_extend_seeds(
                            sq, ev, seeds, k, opts["l"], seedlength,
                            querycompare=True, selfmode=False,
                            allmax=opts["allmax"])
                    else:
                        pmt = hamming_extend_seeds(
                            sq, ev, seeds, k, opts["l"], seedlength,
                            querycompare=True, allmax=opts["allmax"])
                else:
                    pmt = find_query_matches(
                        esa, qrc, opts["l"], "mem",
                        flags_extra=spflags, qspeedup=qsp)
                tables.append(pmt)
            mt = MatchTable.concat(tables)
            raw = mt
            # query=ms only when a palindromic part exists: the
            # funnel's flip needs the sequence bounds, while plain
            # self tasks must keep the indexed-query multiplier
            mt = process_final(mt, ms, ev, mp,
                               query=ms if opts["p"] else None,
                               selection=hooks)
            # self-palindromic dedup (procfinal.c:159-171): keep only
            # (seq1,rel1) <= (seq2,rel2) after the coordinate flip
            sp = (mt.flag & FLAGSELFPALINDROMIC) != 0
            if sp.any():
                drop = sp & (
                    (mt.seqnum1 > mt.seqnum2)
                    | ((mt.seqnum1 == mt.seqnum2)
                       & (mt.relpos1 > mt.relpos2)))
                mt = mt.select(~drop)
                mt.idnumber = np.arange(len(mt), dtype=np.int64)
            return finish(mt, raw=raw)
        raise SystemExit("vmatch: task not implemented yet")

    if opts["dnavsprot"] is not None:
        # -dnavsprot: DNA queries against a protein index
        # (procmatch.c:440-462): read queries with a DNA symbol map,
        # six-frame-translate into the index alphabet, match the
        # translated queries, then back-map coordinates to the DNA
        from ..core.alphabet import dna_alphabet, read_symbolmap
        from ..core.codon import six_frame_translate

        if opts["supermax"] or opts["tandem"] or \
                opts.get("dbcluster") is not None:
            raise SystemExit(
                "vmatch: option -dnavsprot excludes self-match tasks")
        dna_alpha = (read_symbolmap(opts["dnavsprot_smap"])
                     if opts["dnavsprot_smap"] else dna_alphabet())
        dnaquery = read_multiseq(opts["q"], dna_alpha,
                                 store_original=True)
        query = six_frame_translate(dnaquery, esa.alpha,
                                    opts["dnavsprot"])
        assign_query_digits(digits, dnaquery)
    else:
        dnaquery = None
        query = read_multiseq(opts["q"], esa.alpha, store_original=True)
        assign_query_digits(digits, query)

    def _dnavsprot_convert(mt):
        """dnavsprotfromsixframetooriginalquery (procfinal.c:262-289):
        translated-space coordinates back onto the DNA query."""
        if dnaquery is None or len(mt) == 0:
            return mt
        from ..core.codon import sixframe_convert_match
        from ..engine.match import FLAGPPRIGHTREVERSE

        dseq, rel, abspos, dlen, rev = sixframe_convert_match(
            dnaquery, mt.seqnum2, mt.relpos2, mt.length2)
        mt.seqnum2 = dseq
        mt.relpos2 = rel
        mt.position2 = abspos
        mt.length2 = dlen
        mt.transnum = np.full(len(mt), opts["dnavsprot"], np.int64)
        mt.flag = mt.flag | np.where(rev, FLAGPPRIGHTREVERSE, 0)
        return mt

    # -d/-p direction selection (parsevm.c: SHOWDIRECT is the default;
    # -p alone disables direct unless -d is also given)
    direct_on = opts["d"] or not opts["p"]

    if opts["complete"]:
        # reference order (runquery.c:283-321): all direct matches
        # first (queries in input order), then all palindromic
        if opts["l"]:
            raise SystemExit(
                "vmatch: option -l and option -complete exclude each other"
            )
        starts = np.array(
            [query.seq_bounds(i)[0] for i in range(query.numofsequences)],
            np.int64,
        )
        k_h = opts.get("h")
        k_e = opts.get("e")

        def run_pats(q, flags):
            ps = [
                q.sequence[slice(*q.seq_bounds(i))]
                for i in range(q.numofsequences)
            ]
            if opts["online"]:
                from ..engine.online import online_complete_matches

                kind = ("edit" if k_e is not None
                        else "hamming" if k_h is not None else "exact")
                return online_complete_matches(
                    esa, ps, k_e if k_e is not None else (k_h or 0),
                    kind, flags_extra=flags, query_starts=starts,
                )
            if k_e is not None:
                return approx_complete_matches(
                    esa, ps, k_e, edit=True, flags_extra=flags,
                    query_starts=starts,
                )
            if k_h is not None:
                return approx_complete_matches(
                    esa, ps, k_h, edit=False, flags_extra=flags,
                    query_starts=starts,
                )
            return exact_complete_matches(
                esa, ps, flags_extra=flags, query_starts=starts,
                mesh=mesh,
            )

        def rm_redundant(mt):
            # -complete remred (edistcompl.c:20-66 CHECKMATCHPOSITION):
            # the right-to-left scan keeps a single CANDIDATE; a match
            # one position left of the candidate replaces it only on a
            # strictly better distance (else it is consumed); any
            # non-adjacent match emits the candidate and starts anew
            if len(mt) == 0:
                return mt
            order = np.lexsort((-mt.position1, mt.seqnum2, mt.flag))
            keep = np.zeros(len(mt), bool)
            cand = None
            cand_pos = cand_d = 0
            prev_key = None
            for oi in order:
                keyg = (int(mt.flag[oi]), int(mt.seqnum2[oi]))
                p = int(mt.position1[oi])
                d = abs(int(mt.distance[oi]))
                if cand is not None and keyg == prev_key \
                        and p + 1 == cand_pos:
                    if d < cand_d:
                        cand, cand_pos, cand_d = oi, p, d
                    # else: consumed by the candidate
                else:
                    if cand is not None:
                        keep[cand] = True
                    cand, cand_pos, cand_d = oi, p, d
                prev_key = keyg
            if cand is not None:
                keep[cand] = True
            return mt.select(keep)

        tables: list[MatchTable] = []
        if direct_on:
            mt0 = run_pats(query, 0)
            if opts["removeredundant"] and opts["online"] \
                    and k_e is not None:
                mt0 = rm_redundant(mt0)
            tables.append(mt0)
        if opts["p"]:
            qrc = reverse_complement_inplace(query)
            mt1 = run_pats(qrc, FLAGPALINDROMIC)
            if opts["removeredundant"] and opts["online"] \
                    and k_e is not None:
                mt1 = rm_redundant(mt1)
            tables.append(mt1)
        allmt = _dnavsprot_convert(MatchTable.concat(tables))
        raw = allmt
        outq = dnaquery if dnaquery is not None else query
        allmt = process_final(allmt, ms, ev, mp, query=outq,
                              selection=hooks)
        return finish(allmt, query=outq, raw=raw)

    if opts["l"] is not None or xdrop is not None:
        # substring matching: MEMs / MUM candidates / MUMs
        # (reference runquery.c:71-353 -> fquery.c findquerymatches),
        # optionally seed-extended for -e/-h/-exdrop/-hxdrop
        if opts["mum"]:
            mode = "mumcand" if opts.get("mumcand") else "mum"
        else:
            mode = "mem"
        k_h = opts.get("h")
        k_e = opts.get("e")
        k = k_e if k_e is not None else k_h

        if opts["online"]:
            # -online -q: per-query-sequence throwaway index, database
            # scanned against it (procmatch.c:34-133 + runquery)
            from ..engine.onlinequery import online_query_matches
            from ..engine.query import _unique_in_query

            if mode == "mum" and query.numofsequences > 1:
                raise SystemExit(
                    "vmatch: options -mum, -q, and -online can only "
                    "be combined if there is exactly one sequence in "
                    "the query file")
            allmt = online_query_matches(
                esa, query,
                opts["l"] if opts["l"] is not None else 0,
                mode, ev=ev, leastlength=opts["l"] or 0,
                k_e=k_e, k_h=k_h, xdrop=xdrop,
                seedlength=opts.get("seedlength"),
                direct=direct_on, palindromic=opts["p"])
            if mode == "mum":
                allmt = _unique_in_query(allmt, query)
            raw = allmt
            allmt = process_final(allmt, ms, ev, mp, query=query,
                                  selection=hooks)
            return finish(allmt, query=query, raw=raw)

        def run_q(q, flags):
            if xdrop is not None:
                seedlength = opts.get("seedlength") or 30
                seeds = find_query_matches(esa, q, seedlength, "mem",
                                           flags_extra=flags,
                                           qspeedup=qsp)
                sq = Seqs(ms.sequence, q.sequence)
                return xdrop_extend_seeds(sq, seeds, xdrop, seedlength,
                                          querycompare=True)
            if k is None:
                return find_query_matches(esa, q, opts["l"], mode,
                                          flags_extra=flags,
                                          qspeedup=qsp)
            seedlength = max(opts.get("seedlength") or 0,
                             opts["l"] // (k + 1))
            seeds = find_query_matches(esa, q, seedlength, "mem",
                                       flags_extra=flags,
                                       qspeedup=qsp)
            sq = Seqs(ms.sequence, q.sequence)
            if k_e is not None:
                return edit_extend_seeds(
                    sq, ev, seeds, k, opts["l"], seedlength,
                    querycompare=True, selfmode=False,
                    allmax=opts["allmax"])
            return hamming_extend_seeds(
                sq, ev, seeds, k, opts["l"], seedlength,
                querycompare=True, allmax=opts["allmax"])

        tables = []
        if direct_on:
            tables.append(run_q(query, 0))
        if opts["p"]:
            qrc = reverse_complement_inplace(query)
            tables.append(run_q(qrc, FLAGPALINDROMIC))
        allmt = _dnavsprot_convert(MatchTable.concat(tables))
        raw = allmt
        outq = dnaquery if dnaquery is not None else query
        allmt = process_final(allmt, ms, ev, mp, query=outq,
                              selection=hooks)
        return finish(allmt, query=outq, raw=raw)

    raise SystemExit("vmatch: task not implemented yet")


def main() -> None:
    import io
    import time

    from ..core.envconf import check_env_on_off

    qs = None
    try:
        qs_env = __import__("os").environ.get("QUERYSPEEDUP")
        if qs_env is not None:
            qs = int(qs_env)
            if qs == 1:
                raise SystemExit(
                    "vmatch: Algorithm 1 is no longer available, "
                    "please use Algorithm 0, or 2; we recommend "
                    "Algorithm 2")
            if qs not in (0, 2, 3, 4, 5):
                raise SystemExit(
                    f"vmatch: illegal speedup value {qs}")
    except ValueError:
        raise SystemExit(
            "vmatch: incorrect value of environment variable "
            "QUERYSPEEDUP; must be non-negative integer")
    showtimespace = check_env_on_off("VMATCHSHOWTIMESPACE")
    import os as _os

    # observability / sanitizer hooks (SURVEY §5 rows 1-2):
    # VSTREE_PROFILE=<dir> records a jax.profiler trace of the whole
    # run (per-kernel device timings, viewable in xprof/tensorboard);
    # VSTREE_DEBUG_NANS=1 arms jax's debug_nans checks
    profile_dir = _os.environ.get("VSTREE_PROFILE")
    if check_env_on_off("VSTREE_DEBUG_NANS"):
        import jax

        jax.config.update("jax_debug_nans", True)

    def run_once(argv, out=None):
        if profile_dir:
            import jax

            jax.profiler.start_trace(profile_dir)
            try:
                return run(argv, out=out) if out is not None \
                    else run(argv)
            finally:
                jax.profiler.stop_trace()
        return run(argv, out=out) if out is not None else run(argv)

    try:
        if showtimespace:
            # timing mode (vmatch.mn.c:44-52,91-96): matches are
            # swallowed, # TIME / # SPACE lines printed at exit
            t0 = time.process_time()
            sink = io.StringIO()
            rc = run_once(sys.argv[1:], out=sink)
            import resource

            peak = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
            print(f"# TIME vmatch {time.process_time() - t0:.2f}")
            print(f"# SPACE vmatch {peak:.2f}")
            sys.exit(rc)
        sys.exit(run_once(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
