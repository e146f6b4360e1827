"""One module per driver, named by a traffic file's `driver`."""
