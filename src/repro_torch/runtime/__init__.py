"""Runtime helpers of the port: offline analysis of exported engine traces."""
