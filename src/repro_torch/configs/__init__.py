"""Architecture registry. Importing this package registers the ported archs.

Only the architectures whose model path the port runs are registered; the
others arrive with the slices that port their layers.
"""

from repro_torch.configs import yi_9b  # noqa: F401

from repro_torch.config.base import get_config, list_archs  # noqa: F401
