import time

STARTED = time.perf_counter()  # set-up counts from here: imports, build, operator, warm-up

import sys  # noqa: E402

from cgbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], started=STARTED))
