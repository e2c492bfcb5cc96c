"""How full the server's batches ran: the images it served over its
batches times ``max_batch`` (``InferenceServer.stats``), over the window;
the rest of each batch is padding rows."""

LAYER = "service (serving/batcher.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "request_p95_s"
BETTER = "higher"
WORKLOADS = ["sd15-serve-mb8"]


def read(record):
    c = record.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["images"] / (c["batches"] * c["max_batch"])
