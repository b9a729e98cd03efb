"""Mean host wait in `next(batches)` a step over the window, timed by the
harness around the port's BatchIterator: a wait means the prefetch thread
(batch assembly, and the semantic tiers' tower) holds the step up."""


def read(rec):
    return rec["host"].get("feed_wait_ms")
