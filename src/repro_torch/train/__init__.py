"""Training substrate of the port: data, AdamW, the train step,
checkpoints, fault tolerance and gradient compression (the reference
package's ``repro.train``)."""
