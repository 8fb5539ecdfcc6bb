"""Pipeline runtimes of the port: the streaming SpecTrain tick loop
(``pipeline_stream``), the staleness-free GPipe baseline
(``pipeline_sync``) and the SpecTrain closed forms (``spectrain``)."""
