"""Entry kind ``fleet``: one job is one ``BatchDecoder`` over the job's
streams, each opened from its own ``io.BytesIO``, decoded whole with the
decoder's defaults (``engine="auto"``, ``clip_samples=True``, float32)."""

import io


def run_job(blobs, device, spans):
    """``(PCM per stream, program runs)`` of one job."""
    from nvorbis_tpu_torch.parallel.batch import BatchDecoder

    with spans.span("bench.open"):
        decoder = BatchDecoder([io.BytesIO(b) for b in blobs], device=device)
    with spans.span("bench.decode"):
        outputs = decoder.decode_all()
    return outputs, dict(decoder.programs)
