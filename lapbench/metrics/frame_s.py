"""frame_s: seconds a request takes, as its caller waits for it:
the whole window over the requests completed in it, host clock
(``Run.per_request_s``)."""


def read(run):
    return run.per_request_s()
