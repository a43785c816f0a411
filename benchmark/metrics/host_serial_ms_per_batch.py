"""Host arithmetic on a request's path after a blocking read, in
milliseconds a request of the traced requests: the host time of the
program's ``host.*`` spans (the points' and y's decode, the challenges, the
solution ids), from the program's own recording. A blocking read leaves the
card nothing queued, so this is idle that no kernel or graph change can
remove."""

from benchmark import recording


def read(ctx):
    return recording.span_ms_per_request(ctx, "host.")
