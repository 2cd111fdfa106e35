import sys

from omegabench.run import main

sys.exit(main())
