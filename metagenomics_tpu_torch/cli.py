"""Command-line driver, flag-compatible with the reference
(MetaGenomics/main.cpp:117-184):

    python -m metagenomics_tpu_torch.cli -pe N f1..fN -se N f1..fN \
        -f prefix -l minOverlap [-s]

The overlap engine comes from MGTPU_OVERLAP_ENGINE (auto by default) and
its device from MGTPU_TORCH_DEVICE (cuda by default).  With
MGTPU_COORDINATOR / MGTPU_NUM_PROCESSES / MGTPU_PROCESS_ID (or torchrun's
variables) set, each process joins one torch.distributed process group
first (parallel/launcher.py).
"""

import sys

from .config import AssemblerConfig
from .assembler import Assembler

_USAGE = """Usage: metagenomics_tpu [OPTION]...[PRARAM]...
  -pe\tnumber of files and paired-end file names
  -se\tnumber of files and single-end file names
  -f\tAll file name prefix
  -l\tminimum overlap length
  -s\tstart from unitig graph
"""


def parse_arguments(argv):
    cfg = AssemblerConfig()
    if len(argv) <= 1:
        sys.stderr.write(_USAGE)
        raise SystemExit(0)
    i = 1
    while i < len(argv):
        a = argv[i]
        if a == "-pe":
            i += 1
            n = int(argv[i])
            for _ in range(n):
                i += 1
                cfg.paired_end_files.append(argv[i])
        elif a == "-se":
            i += 1
            n = int(argv[i])
            for _ in range(n):
                i += 1
                cfg.single_end_files.append(argv[i])
        elif a == "-f":
            i += 1
            cfg.output_prefix = argv[i]
        elif a == "-l":
            i += 1
            cfg.min_overlap = int(argv[i])
        elif a == "-s":
            cfg.resume_from_unitig = True
        elif a == "--clean-flow":
            # new-framework option: license-clean SSP flow solver instead
            # of the CS2-trajectory replay (see config.AssemblerConfig)
            cfg.clean_flow = True
        elif a in ("-h", "--help"):
            sys.stderr.write(_USAGE)
            raise SystemExit(0)
        else:
            sys.stderr.write(_USAGE)
            sys.stderr.write("Unknown option: %s\n\n" % a)
            raise SystemExit(1)
        i += 1
    return cfg


def main(argv=None, mesh=None):
    """Run the assembler on argv; returns the Assembler, whose timings
    hold the phase times.  `mesh` is the sharded engine's
    AssemblerConfig.mesh, which has no command-line flag (nor has the
    reference a mesh)."""
    argv = argv if argv is not None else sys.argv
    from .utils.timing import clock_start, clock_stop
    clk = clock_start("main", src=__file__)
    print("PRINTING ARGUMENTS")
    # the reference echoes each argv followed by a space (main.cpp:126)
    print("".join(a + " " for a in argv))
    # multi-process: joins a torch.distributed process group when
    # MGTPU_COORDINATOR / MGTPU_NUM_PROCESSES / MGTPU_PROCESS_ID (or
    # torchrun's variables) are set; no-op otherwise
    from .parallel.launcher import initialize_distributed
    initialize_distributed()
    cfg = parse_arguments(argv)
    cfg.mesh = mesh
    from .errors import (FlowInfeasibleError, MyExit,
                                         report_my_exit)
    asm = Assembler(cfg)
    try:
        asm.run()
    except MyExit as exc:
        # labeled fatal diagnostic, reference MYEXIT parity (Common.h:47):
        # print the block and exit 0, never a traceback
        report_my_exit(exc)
        raise SystemExit(0)
    except FlowInfeasibleError as exc:
        # CS2 "Error <n>" stderr parity (cs2.h:346)
        sys.stderr.write("\nError %d\n" % exc.code)
        raise SystemExit(exc.code)
    clock_stop("main", clk)
    return asm


if __name__ == "__main__":
    main()
