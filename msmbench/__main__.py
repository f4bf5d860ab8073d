import sys

from msmbench.run import main

sys.exit(main())
