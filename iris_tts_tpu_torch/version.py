"""Version of the iris_tts_tpu_torch port."""

__version__ = "0.1.0"
