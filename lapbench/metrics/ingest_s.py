"""ingest_s: seconds a request spends in ingest (COO to padded ELL: the
``AuctionSolver`` constructor, or the batch's ``from_coo`` calls and
``stack_problems``), the harness's clock around those calls, mean per
request of the traced window."""


def read(run):
    return run.mean_span_s("ingest")
