"""The comparison that decides ``correct`` fails its control and the faults
a cell can have.

Each test drives a whole run of a tiny cell on the CPU (the look for a card
skipped) with the timed path broken underneath, and sees ``correct`` come
out false.  The control, the reference with its IMDCT in TF32, is put in
the program's place as the answers of a job and goes through the same
comparison, which has to find it not correct.  A cell runs on one card, so
it has no exchange between cards to leave out.
"""

import pytest
import torch

from nvorbis_tpu_torch.parallel import batch
from vorbench import cells, check, run
from vorbench.tests.test_vorbench_harness import TINY, tiny_root

# chunks of at most 64 packets, so a job of the tiny cell runs many
SMALL_CHUNKS = (("CHUNK_FRAMES", 64), ("CAP_PER_SIZE", 32))


def tiny_run(tmp_path, seed=21, config="stereo44k_q5"):
    tiny_root(tmp_path, TINY, config)
    bench = cells.load_benchmark(str(tmp_path))
    return run.run_cell(bench, f"{config}.tiny", seed, 0.3, False, "cpu",
                        root=str(tmp_path), max_warmup=1)


@pytest.mark.parametrize("config", ["stereo44k_q5", "surround51_48k_q5"])
def test_sound_runs_pass_and_the_tf32_control_fails(tmp_path, config):
    result, compared, info = tiny_run(tmp_path, config=config)
    limit = result["checks"]["pcm_gap"]["limit"]
    assert result["correct"] and compared["pcm_gap"] <= limit
    assert info["samples"] > 0
    bench = cells.load_benchmark(str(tmp_path))
    cell = run.Cell(bench, f"{config}.tiny", str(tmp_path))
    blobs, sample = cell.jobs(21)
    keeper = check.control_keeper(blobs, sample, cell.channels)
    numbers, _ = check.compare(blobs, keeper)
    assert not check.verdict(numbers, cell.config["check"])
    assert numbers["pcm_gap"] > 3 * limit
    assert numbers["length_mismatches"] == 0


def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    """Each chunk program returns the last chunk's output where the shapes
    agree: a program state that was not advanced."""
    for name, value in SMALL_CHUNKS:
        monkeypatch.setattr(batch, name, value)
    real = batch.batch_program
    last = {}

    def stale(cfg, *flat):
        out = real(cfg, *flat)
        prev = last.get(tuple(out.shape))
        last[tuple(out.shape)] = out.clone()
        return out if prev is None else prev

    monkeypatch.setattr(batch, "batch_program", stale)
    result, compared, _ = tiny_run(tmp_path)
    assert not result["correct"], compared


def test_half_of_the_fleet_left_out(tmp_path, monkeypatch):
    """The job's second half of streams comes back silent (zeros of the
    right length)."""
    entry = cells.entry("fleet")
    real = entry.run_job

    def half(blobs, device, spans):
        outputs, runs = real(blobs, device, spans)
        keep = len(outputs) // 2
        return outputs[:keep] + [0 * o for o in outputs[keep:]], runs

    monkeypatch.setattr(cells, "entry", lambda kind, root=None: type(
        "E", (), {"run_job": staticmethod(half)}))
    result, compared, _ = tiny_run(tmp_path)
    assert not result["correct"], compared


def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch):
    """Every chunk's PCM leaves the chunk program 1e-4 off."""
    real = batch.chunk_output

    def off(*args):
        return real(*args) + torch.tensor(1e-4)

    monkeypatch.setattr(batch, "chunk_output", off)
    result, compared, _ = tiny_run(tmp_path)
    assert not result["correct"], compared


def test_one_chunk_program_altered(tmp_path, monkeypatch):
    """One chunk of each job, in the middle of a stream, leaves its chunk
    program 1e-4 off; the others are right."""
    for name, value in SMALL_CHUNKS:
        monkeypatch.setattr(batch, name, value)
    real = batch.chunk_output
    calls = [0]

    def off_once(*args):
        out = real(*args)
        calls[0] += 1
        return out + torch.tensor(1e-4) if calls[0] == 6 else out

    real_decode = batch.BatchDecoder.decode_all

    def decode_all(self):
        calls[0] = 0
        return real_decode(self)

    monkeypatch.setattr(batch, "chunk_output", off_once)
    monkeypatch.setattr(batch.BatchDecoder, "decode_all", decode_all)
    result, compared, _ = tiny_run(tmp_path)
    assert calls[0] > 10  # the job ran many chunks; one was off
    assert not result["correct"], compared


def test_a_stream_cut_short(tmp_path, monkeypatch):
    """One stream's PCM loses its last packet's samples."""
    entry = cells.entry("fleet")
    real = entry.run_job

    def cut(blobs, device, spans):
        outputs, runs = real(blobs, device, spans)
        return [outputs[0][:-256]] + outputs[1:], runs

    monkeypatch.setattr(cells, "entry", lambda kind, root=None: type(
        "E", (), {"run_job": staticmethod(cut)}))
    result, compared, _ = tiny_run(tmp_path)
    assert not result["correct"] and compared["length_mismatches"] > 0
