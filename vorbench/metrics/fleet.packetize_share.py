"""Share of the window in the program's ``batch.packetize`` span: the C++
packetization of each source's whole logical stream (``table_for_decoder``)
while each job's ``BatchDecoder`` opens its sources, on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.packetize")
    return None if s is None else 100.0 * s / ctx["window_s"]
