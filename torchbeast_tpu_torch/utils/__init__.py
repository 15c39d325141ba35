from torchbeast_tpu_torch.utils.file_writer import FileWriter  # noqa: F401
from torchbeast_tpu_torch.utils.preempt import (  # noqa: F401
    install_preemption_handler,
)
from torchbeast_tpu_torch.utils.prof import Timings  # noqa: F401
