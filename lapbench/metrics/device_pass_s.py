"""device_pass_s: seconds of the device pass a request (the program's
``meta["device_time"]``: host clock after a synchronise; a batch's total
over its chunks), mean per request of the traced window."""


def read(run):
    return run.mean_meta("device_time")
