from .profiling import StepTimer, enable_nan_checks, trace
from .tb_writer import TBWriter
