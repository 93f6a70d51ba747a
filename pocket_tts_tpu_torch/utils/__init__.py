"""Part of the pocket_tts_tpu_torch port; see the package docstring."""
