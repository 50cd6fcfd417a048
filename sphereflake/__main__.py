import sys

from sphereflake.cli import main

sys.exit(main())
