"""setup_s: process start -> the first timed request (host clock):
interpreter and CUDA, the KB's generation and load, attach, the draw of
the requests and the warm-up, and on a checkout's first run the kernel
and scanner builds."""


def read(run):
    return run.setup_s
