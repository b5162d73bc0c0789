"""The ``sevennet-tpu-torch`` command line (:mod:`.main`)."""
