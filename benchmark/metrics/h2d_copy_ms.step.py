"""h2d_copy_ms.step: device ms per traced step of host-to-device copies
(the profiler's Memcpy HtoD rows): the batch going to the card."""

from benchmark import readers


def read(record):
    return readers.traced_ms(record, "replay", lambda tr: tr["h2d_s"])
