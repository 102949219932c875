"""Request kinds. A traffic mix (``traffic/<mix>.json``) names one by its
``kind`` and gives its parameters; the kind's module here draws each
request from a client's random stream, calls the port, counts the
request's logical work from its shapes, and answers it by the plain
reference of the configuration it runs on.

A kind module defines:

* ``prepare(dep, params)``: the program-side state the calls share;
* ``draw(rng, dep, params)``: one request, a plain value;
* ``call(state, request)``: the port's answer;
* ``least_seconds(dep, params, request)``: the least device time of the request's
  logical work (``bounds``), or None where no kernel roofline is read;
* ``expected(dep, params, request)``: the reference's answer;
* ``prepare_control(dep, params)`` and ``control_call(ctrl, request)``: the
  reference with one guarantee of the configuration broken, answering in
  the port's place.
"""
