"""hk_passes: passes the cardinality pre-check's matcher makes over the
free rows (the program's counter ``passes`` of its ``hk`` span), mean per
request of the traced window.  None where no ``hk`` span of the window
holds the counter: a program that does not record it."""

from lapbench import program_spans


def read(run):
    reqs = program_spans.requests(run)
    if reqs is None or not any(s["name"] == "hk" and "passes" in s["counts"]
                               for spans in reqs for s in spans):
        return None
    return sum(s["counts"].get("passes", 0) for spans in reqs
               for s in spans if s["name"] == "hk") / len(reqs)
