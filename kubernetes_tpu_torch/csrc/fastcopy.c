/* Deep copy for JSON-shaped Python data (dict/list/scalars), in C.
 *
 * The store deep-copies every object on every read/write/watch-emit (the
 * mutation-isolation discipline the reference enforces with its cache
 * mutation detector) — at 150k-pod scale this is the control plane's
 * single largest interpreted cost.  Python recursion pays dispatch +
 * frame overhead per node; this walks the same structure with direct
 * CPython API calls.  Scalars (str/int/float/bool/None) are immutable
 * and shared by reference, exactly like the Python implementation.
 *
 * Called via ctypes.PyDLL (GIL held).  Non-dict/list containers are
 * treated as scalars — the store's wire form never contains them.
 */

#include <Python.h>

static PyObject *fc_copy(PyObject *obj);

PyObject *fc_deepcopy(PyObject *obj) {
    return fc_copy(obj);
}

static PyObject *fc_copy(PyObject *obj) {
    if (PyDict_CheckExact(obj)) {
        PyObject *out = PyDict_New();
        if (!out) return NULL;
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (Py_EnterRecursiveCall(" in fastcopy")) { Py_DECREF(out); return NULL; }
            PyObject *cv = fc_copy(v);
            Py_LeaveRecursiveCall();
            if (!cv) { Py_DECREF(out); return NULL; }
            if (PyDict_SetItem(out, k, cv) < 0) {
                Py_DECREF(cv);
                Py_DECREF(out);
                return NULL;
            }
            Py_DECREF(cv);
        }
        return out;
    }
    if (PyList_CheckExact(obj)) {
        Py_ssize_t n = PyList_GET_SIZE(obj);
        PyObject *out = PyList_New(n);
        if (!out) return NULL;
        for (Py_ssize_t i = 0; i < n; i++) {
            if (Py_EnterRecursiveCall(" in fastcopy")) { Py_DECREF(out); return NULL; }
            PyObject *cv = fc_copy(PyList_GET_ITEM(obj, i));
            Py_LeaveRecursiveCall();
            if (!cv) { Py_DECREF(out); return NULL; }
            PyList_SET_ITEM(out, i, cv); /* steals cv */
        }
        return out;
    }
    Py_INCREF(obj);
    return obj;
}
