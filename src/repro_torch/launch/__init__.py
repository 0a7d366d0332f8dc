"""Entry points of the port: training (`train`) and the serving testbed
(`serve.build_testbed`)."""
