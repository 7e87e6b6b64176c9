"""The check must fail what it exists to catch.  The control (the
reference at a lower precision in the program's place) comes out not
correct in every cell; and a run driven on the CPU, past the harness's
look for a card, comes out not correct with the timed path broken
underneath in each way a cell can break: a step that returns its state
unchanged, half of a batch left out, an answer altered where it is
produced.  (No cell spans chips, so none can leave out an exchange.)"""

import numpy as np
import pytest

from benchmark import control, harness

CELLS = ["m1v1080_single", "m1v1080_single_prefetch", "m1v1080_64streams",
         "ps1080_av_player"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 99, 4100000003])
def test_the_control_is_not_correct(small, cell, seed):
    checks = control.control_checks(cell, seed, 3000, harness.CACHE_DIR,
                                    folder=small)
    assert not harness.passed(checks)
    assert checks["frames_wrong"]["value"] > 0


@pytest.fixture
def run(small):
    def run(cell, seconds=1.0):
        res, lines = harness.run_cell(cell, 11, seconds, False,
                                      device="cpu", folder=small,
                                      cache_dir=harness.CACHE_DIR)
        return res
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(run, cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["frames_compared"]["value"] > 0


def _state_unchanged(cur, fwd, bwd, *plan_and_geom):
    return cur


def _altered(recon):
    def run(*a):
        out = recon(*a).clone()
        out[1000] ^= 1
        return out
    return run


@pytest.mark.parametrize("cell", ["m1v1080_single", "m1v1080_64streams",
                                  "ps1080_av_player"])
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_a_broken_reconstruct_is_caught(monkeypatch, run, cell, fault):
    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import BatchVideoDecoder, batch
    if cell == "m1v1080_64streams" and fault == "state_unchanged":
        monkeypatch.setattr(cuda_kernels, "reconstruct_pictures",
                            lambda *a: None)
    elif cell == "m1v1080_64streams":
        from mpeg_tpu_torch.parallel import multistream
        orig = multistream.GlobalWindowDecoder.reconstruct

        def broken(self, carry, plan, flags):
            new_carry, disps = orig(self, carry, plan, flags)
            disps = disps.clone()
            disps[..., 1000] ^= 1
            return new_carry, disps
        monkeypatch.setattr(multistream.GlobalWindowDecoder, "reconstruct",
                            broken)
    else:
        fn = _state_unchanged if fault == "state_unchanged" \
            else _altered(cuda_kernels.reconstruct_picture)
        monkeypatch.setattr(BatchVideoDecoder, "_recon", staticmethod(fn))
        orig = batch.PictureBlobRecon.forward

        def blob_recon(self, cur, fwd, bwd, *a, **k):
            if fault == "state_unchanged":
                return cur
            out = orig(self, cur, fwd, bwd, *a, **k).clone()
            out[1000] ^= 1
            return out
        monkeypatch.setattr(batch.PictureBlobRecon, "forward", blob_recon)
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["frames_wrong"]["value"] > 0


def test_half_the_streams_left_out_is_caught(monkeypatch, run):
    from mpeg_tpu_torch.parallel import MultiStreamVideoDecoder
    orig = MultiStreamVideoDecoder.decode_window

    def half(self):
        got = orig(self)
        if got is None:
            return None
        return [f if s % 2 == 0 else [] for s, f in enumerate(got)]
    monkeypatch.setattr(MultiStreamVideoDecoder, "decode_window", half)
    res = run("m1v1080_64streams", seconds=30.0)
    assert not res["correct"]
    assert res["checks"]["frames_missing"]["value"] > 0


def test_altered_pcm_is_caught(monkeypatch, run):
    from mpeg_tpu_torch import audio
    orig = audio.Audio._synthesize

    def altered(self, samples_int):
        orig(self, samples_int)
        pcm = np.array(self.samples.interleaved)
        pcm[7] += np.float32(1e-3)
        self.samples.interleaved = pcm
    monkeypatch.setattr(audio.Audio, "_synthesize", altered)
    res = run("ps1080_av_player")
    assert not res["correct"]
    assert res["checks"]["pcm_wrong"]["value"] > 0
