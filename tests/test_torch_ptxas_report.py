"""chip_smoke.py's reading of ptxas's -v report, on the CPU: kernel names
from mangled ones, and the spills of a device function that is not
inlined (the GGNN step body), which ptxas reports apart from the kernel
that calls it, so that the card's spill gate sees them."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_report", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

_NS = "_GLOBAL__N__42f358d2_12_ggnn_step_cu_25eec7d3"
STEP_KERNEL = f"_ZN45{_NS}16ggnn_step_kernelILi128ELi2ELb1EEEvNS_8StepArgsEPKfPKNS_3MsgIXT0_EE1TES3_"
STEP_TILE = (f"_ZN43_INTERNAL_42f358d2_12_ggnn_step_cu_25eec7d345{_NS}9step_tileILi128ELi2ELb1E"
             "Lb1EaEEvNS0_8StepArgsEPfiPKfPKT3_S5_PKjS3_S3_S3_PaS3_")
STEP_TILE_BF16 = (f"_ZN43_INTERNAL_42f358d2_12_ggnn_step_cu_25eec7d345{_NS}9step_tileILi64ELi1ELb0E"
                  "Lb0E13__nv_bfloat16EEvNS0_8StepArgsE")
COLMAX_WARP = (f"_ZN43_INTERNAL_42f358d2_12_ggnn_step_cu_25eec7d345{_NS}15mxu_colmax_warpILi128ELb0E"
               "EEvNS0_8StepArgsEiPfPKaS5_PKfPjii")
FLASH = "_ZN45_GLOBAL__N__aabbccdd_18_flash_attention_cu_1122334416flash_fwd_scalarIfLi64ELb1EEEvPKf"


@pytest.mark.parametrize("mangled, name", [
    (STEP_KERNEL, "ggnn_step_kernel<128, 2, mxu>"),
    (STEP_TILE, "step_tile<128, 2, mxu, coherent>"),
    (STEP_TILE_BF16, "step_tile<64, 1>"),
    (COLMAX_WARP, "mxu_colmax_warp<128>"),
    (FLASH, "flash_fwd_scalar<float, 64, causal>"),
], ids=["kernel", "noinline_body", "bf16_body", "prepass_body", "flash"])
def test_kernel_names(mangled, name):
    assert cs.kernel_name(mangled) == name


def test_a_noinline_function_reports_its_own_spills():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{STEP_KERNEL}' for 'sm_90a'",
        f"ptxas info    : Function properties for {STEP_KERNEL}",
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size",
        "ptxas info    : Compile time = 257.846 ms",
        f"ptxas info    : Function properties for {STEP_TILE}",
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        f"ptxas info    : Compiling entry function '{FLASH}' for 'sm_90a'",
        f"ptxas info    : Function properties for {FLASH}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers",
    ])
    assert cs.ptxas_summary(log) == {
        "ggnn_step_kernel<128, 2, mxu>": {"registers": 128, "spill_bytes": 0},
        "step_tile<128, 2, mxu, coherent>": {"registers": None, "spill_bytes": 12},
        "flash_fwd_scalar<float, 64, causal>": {"registers": 96, "spill_bytes": 0},
    }
