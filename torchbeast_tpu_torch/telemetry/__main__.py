"""`python -m torchbeast_tpu_torch.telemetry --selftest` — exporter CLI
(avoids runpy's found-in-sys.modules warning that
`-m torchbeast_tpu_torch.telemetry.export` triggers via the package init)."""

import sys

from torchbeast_tpu_torch.telemetry.export import main

if __name__ == "__main__":
    sys.exit(main())
