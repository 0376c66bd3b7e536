"""The port's own kernels, found in its CUDA sources, and the names the
profiler gives them."""

import os

from portbench import trace
from portbench.tests.conftest import ROOT


def test_own_kernels_are_found_in_the_sources():
    own = trace.own_kernels(os.path.join(ROOT, "sgracex1_tpu_torch", "csrc"))
    for k in ("agg_ring_kernel", "flash_ring_kernel", "flash_gat_kernel", "bwd_row_kernel",
              "bwd_col_kernel", "stage_h_kernel", "plan_gather_kernel", "merge_runs"):
        assert k in own


def test_base_name_of_profiler_kernel_names():
    assert trace.base_name("void sgr::stage_h_kernel<float>(float const*, int)") == "stage_h_kernel"
    assert trace.base_name("void sg::flash::flash_gat_kernel<2, false>(sg::flash::Args)") == "flash_gat_kernel"
    assert trace.base_name("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8") == \
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"
    assert trace.base_name("Memcpy HtoD (Pageable -> Device)") == "HtoD"


def test_merge_of_device_intervals():
    assert trace._merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
