"""``python -m goicp_tpu_torch <scenario.toml>`` — the port's CLI
(:mod:`goicp_tpu_torch.cli`).

``python -m goicp_tpu_torch serve …`` (the JAX package's registration
service) is not ported yet and raises.
"""

import sys

if len(sys.argv) > 1 and sys.argv[1] == "serve":
    raise NotImplementedError(
        "serve is not ported yet (ROADMAP queue 1, item 5: serving)"
    )

from goicp_tpu_torch.cli import main  # noqa: E402

sys.exit(main())
