"""Monte-Carlo simulation harnesses (port of
``ldpc_tpu.monte_carlo_simulation``): the host BSC simulation, the
memory-experiment and QSS host modules, and the device-resident
Monte-Carlo and QSS pipelines, on one device or sharded over a mesh.
"""

from ldpc_tpu_torch.monte_carlo_simulation.mcs import (  # noqa: F401
    MonteCarloBscSimulation,
)
from ldpc_tpu_torch.monte_carlo_simulation.data_utils import BpParams  # noqa: F401
from ldpc_tpu_torch.monte_carlo_simulation.memory_experiment import (  # noqa: F401
    build_multiround_pcm,
    decode_multiround,
    move_syndrome,
)
from ldpc_tpu_torch.monte_carlo_simulation import simulation_utils  # noqa: F401
from ldpc_tpu_torch.monte_carlo_simulation.device_mc import (  # noqa: F401
    DeviceMonteCarlo,
    make_mc_decoder_step,
    make_sharded_mc_step,
)
from ldpc_tpu_torch.monte_carlo_simulation.quasi_single_shot import (  # noqa: F401
    QssSimulator,
    QSS_SimulatorV2,
)
from ldpc_tpu_torch.monte_carlo_simulation.device_qss import (  # noqa: F401
    DeviceQss,
    make_qss_step,
    make_sharded_qss_step,
)

__all__ = [
    "MonteCarloBscSimulation",
    "DeviceMonteCarlo",
    "make_mc_decoder_step",
    "make_sharded_mc_step",
    "BpParams",
    "build_multiround_pcm",
    "decode_multiround",
    "move_syndrome",
    "simulation_utils",
    "QssSimulator",
    "QSS_SimulatorV2",
    "DeviceQss",
    "make_qss_step",
    "make_sharded_qss_step",
]
