"""``chip_smoke.py`` as a module: what can be said of it without a card.

The script needs a CUDA device to run.  Here it is only imported: the
import must touch neither ``torch`` nor the port, the flagship is fixed
at its full width (no argument makes it smaller), and ``main`` refuses
to run without CUDA.
"""

import inspect
import sys

import chip_smoke


def test_flagship_is_fixed_at_full_width():
    assert (chip_smoke.MESH_N, chip_smoke.FLAGSHIP_DOFS) == (64, 840_015)
    assert list(inspect.signature(chip_smoke.flagship).parameters) == [
        "build_astrocyte", "baseline", "SolverOptions"]


def test_every_kernel_has_a_source_and_a_tpu_origin():
    assert len(chip_smoke.KERNEL_SOURCES) == 14
    # K11f fills the drift of both KNP branches; K11 is the per-ion one's
    assert set(chip_smoke.BATCHED_PATH) == set(chip_smoke.KERNEL_SOURCES) - {"K11"}
    assert "K11f" in chip_smoke.ASSEMBLY
    assert set(chip_smoke.CELL_KERNELS) < set(chip_smoke.ASSEMBLY)


def test_main_refuses_without_cuda(capsys):
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err


def test_step_diff_reads_an_ab_by_kernel_name(tmp_path, capsys):
    """``--step-diff`` on the host: parent, change, change, parent legs of
    both multigrid paths; the change drops kernel "a", adds "c" and
    slows "b" at an equal count."""
    import json

    def leg(pkg, banded, ms, kernels):
        return json.dumps(dict(phase="step_profile", package=pkg, mg_banded=banded,
                               device_kernel_ms_per_step=ms, all_kernels=kernels))

    parent = {"a": [1.0, 4.0], "b": [2.0, 8.0]}
    change = {"b": [2.5, 8.0], "c": [0.25, 2.0]}
    legs = []
    for pkg, kernels, ms in (("P", parent, 3.0), ("C", change, 2.75),
                             ("C", change, 2.75), ("P", parent, 3.5)):
        legs += [leg(pkg, False, ms, kernels), leg(pkg, True, ms, kernels)]
    path = tmp_path / "ab.txt"
    path.write_text("\n".join(["NVIDIA H100", *legs]) + "\n")
    assert chip_smoke.main(["--step-diff", str(path)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["mg_banded"] for r in rows] == [False, True]
    for r in rows:
        assert r["parent_ms"] == [3.0, 3.5] and r["change_ms"] == [2.75, 2.75]
        assert r["change_less_parent_ms"] == -0.5 and r["parent_spread_ms"] == 0.5
        assert r["net_count_moved_ms"] == -0.75 and r["net_count_equal_ms"] == 0.5
        assert [(t["name"], t["ms"]) for t in r["top"]] == [("a", -1.0), ("b", 0.5),
                                                          ("c", 0.25)]
