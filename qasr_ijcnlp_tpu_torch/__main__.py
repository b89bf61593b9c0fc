"""``python -m qasr_ijcnlp_tpu_torch`` is the transcribe CLI (the JAX
package's ``__main__``; reference whisper/__main__.py)."""

from .cli.transcribe import main

main()
