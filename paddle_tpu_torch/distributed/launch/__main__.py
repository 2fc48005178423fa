import sys

from .main import launch

sys.exit(launch())
