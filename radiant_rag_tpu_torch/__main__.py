"""`python -m radiant_rag_tpu_torch`: the port's CLI (`app.main`)."""

import sys

from radiant_rag_tpu_torch.app import main

if __name__ == "__main__":
    sys.exit(main())
