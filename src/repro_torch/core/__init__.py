"""SNAKE core: 3D-stacked NMP compute-substrate + scheduling models.

The port's copy of the reference's host-only analytic model (numpy, no
device code); `tests/test_torch_core.py` holds it equal to the reference.
"""
from repro_torch.core.dataflow import (CoreExec, best_logical_shape, mactree_gemm,
                                       sa_gemm, sa_gemm_auto, sa_gemm_best)
from repro_torch.core.energy import EnergyReport, gemm_energy, peak_power_breakdown
from repro_torch.core.gemm import Dataflow, Gemm, OpClass, ceil_div, pad_to
from repro_torch.core.gpu_model import GPUDecodeReport, gpu_decode_step
from repro_torch.core.hw import (H100, FP16_BYTES, BufferConfig, GPUConfig,
                                 MacTreeConfig, NMPSystem, SystolicArrayConfig,
                                 area_model, fixed_sa_system, mactree_system,
                                 snake_system)
from repro_torch.core.operators import (DEEPSEEK_236B, LLAMA3_70B, MIXTRAL_8X22B,
                                        OPT_66B, PAPER_MODELS, QWEN3_30B_A3B,
                                        MLASpec, ModelSpec, MoESpec, decode_ops,
                                        layer_ops)
from repro_torch.core.pipeline import DecodeReport, decode_step, decode_sweep
from repro_torch.core.schedule import (Mode, OpExec, mode_candidates,
                                       schedule_attention, schedule_chain,
                                       schedule_experts, schedule_projection)
from repro_torch.core.serving_sim import (ServingReport, gpu_latency_model,
                                          nmp_latency_model, simulate_serving)

__all__ = [n for n in dir() if not n.startswith("_")]
