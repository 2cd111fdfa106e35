"""Reference-style fatal diagnostics.

The reference's MYEXIT macro (MetaGenomics/Common.h:47) prints

    Exit from File: <file> Line: <line> Function: <fn>()
    Message: <msg>

and exits with status 0; the bundled CS2 solver instead prints "Error <n>"
to stderr and exits with that code on an infeasible instance (cs2.h:346).
`MyExit` carries the former; the CLI driver renders it and exits 0 so
degenerate inputs produce a labeled diagnostic, never a traceback.
"""

import sys


class MyExit(Exception):
    """Fatal assembler diagnostic (MYEXIT parity, Common.h:47)."""


class FlowInfeasibleError(Exception):
    """The min-cost-flow instance has no feasible circulation (e.g. an
    empty graph leaves the lb=1 return arc unroutable).  `.code` is the
    CS2-compatible exit code (cs2.h:346); the CLI renders "Error <n>" on
    stderr and exits with it, while library embedders of Assembler.run can
    catch this instead of a process-killing SystemExit (ADVICE r4)."""

    def __init__(self, code=2):
        super().__init__("Error %d" % code)
        self.code = code


def report_my_exit(exc: MyExit, out=None) -> None:
    """Print the MYEXIT block for `exc` using its raise site."""
    out = out or sys.stdout
    tb = exc.__traceback__
    file_name = "?"
    line = 0
    func = "?"
    if tb is not None:
        while tb.tb_next is not None:
            tb = tb.tb_next
        file_name = tb.tb_frame.f_code.co_filename
        line = tb.tb_lineno
        func = tb.tb_frame.f_code.co_name
    msg = exc.args[0] if exc.args else ""
    out.write("\nExit from File: %s Line: %d Function: %s()\nMessage: %s\n"
              % (file_name, line, func, msg))
    out.flush()
