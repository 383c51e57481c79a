"""The two-process deployment of the collaborative prover: the harness
each party runs (:mod:`.main`) and a launcher that runs both on one
machine over loopback (:mod:`.launch`)."""
