"""Small host-side utilities shared by the drivers (port of
`ngravs_tpu/utils/__init__.py`)."""

import atexit
import shutil
import tempfile


def scratch_output_dir() -> str:
    """A process-lifetime scratch directory for run artifacts when no
    OutputDir was configured (never litter the CWD).  Removed at interpreter
    exit; set OutputDir or pass log_dir/path for persistent artifacts."""
    d = tempfile.mkdtemp(prefix="ngravs_out_")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d
