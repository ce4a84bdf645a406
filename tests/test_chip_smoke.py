"""chip_smoke.py's phases at tiny sizes on the CPU backend (the card
runs them at full size), and its refusal to run without a GPU."""

import json

import pytest

import chip_smoke


def test_phase_api():
    res = chip_smoke.phase_api(framebits=96, batch=40, sample=16)
    assert res["frames"] == 40 and res["golden_sample"] == 16


def test_phase_ladder():
    res = chip_smoke.phase_ladder(kbps=(8, 32), batch=12, sample=4)
    assert res["offgrid_framebits"] == 50


def test_phase_kernel_vs_xla():
    """Off the card the 'kernel' side is another XLA variant: the
    equality check and the alternating timing still run."""
    res = chip_smoke.phase_kernel_vs_xla(shapes=((96, 33),),
                                         variant="jax_scan", reps=1)
    for label in ("upload", "resident"):
        times = res[f"fb96_B33_ms_per_call_{label}"]
        assert len(times["kernel"]) == 2 and len(times["xla"]) == 2


def test_phase_rs():
    res = chip_smoke.phase_rs(n_codewords=300, sample=8, rs_dims=4)
    # 9 byte errors are beyond t=5; a few land within 5 of another
    # codeword and decode (golden agrees: the phase checks that)
    assert 50 <= res["uncorrectable"]["uncorrectable"] <= 64
    assert res["clean"]["uncorrectable"] == 0


def test_phase_chain():
    res = chip_smoke.phase_chain(n_superframes=4, bitrate=32, sample=2)
    assert res["superframes"] == 4


def test_phase_reach():
    assert chip_smoke.phase_reach()["local_blocks"] == 3


def test_phase_four_on_virtual_devices():
    """The --four paths on 4 of the 8 virtual CPU devices."""
    res = chip_smoke.phase_four(n_superframes=4, bitrate=32,
                                block_bits=192, batch=4)
    assert set(res) == {"dp_superframes", "sp_1x4", "sp_2x2"}


def test_main_refuses_cpu(capsys):
    """No GPU: a non-zero exit and no result line."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    for line in capsys.readouterr().out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
