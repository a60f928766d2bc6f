"""csc_s: seconds of the FR tail's column table (CSC) build (the
program's span ``csc``, inside ``host_tables``), mean per request of the
traced window.  None where no request of the window holds a ``csc`` span:
a program that does not record it."""

from lapbench import program_spans


def read(run):
    reqs = program_spans.requests(run)
    if reqs is None or not any(s["name"] == "csc" for spans in reqs
                               for s in spans):
        return None
    return sum(program_spans.total_s(spans, "csc")
               for spans in reqs) / len(reqs)
