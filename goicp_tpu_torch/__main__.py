"""``python -m goicp_tpu_torch <scenario.toml>`` — the port's CLI
(:mod:`goicp_tpu_torch.cli`); ``python -m goicp_tpu_torch serve …`` — the
registration service (:mod:`goicp_tpu_torch.serving.cli`)."""

import sys

if len(sys.argv) > 1 and sys.argv[1] == "serve":
    from goicp_tpu_torch.serving.cli import main

    sys.exit(main(sys.argv[2:]))

from goicp_tpu_torch.cli import main  # noqa: E402

sys.exit(main())
