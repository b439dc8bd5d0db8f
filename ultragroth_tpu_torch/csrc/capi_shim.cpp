// Stable `extern "C"` FFI surface of the PyTorch port: the same symbols,
// error codes and buffer-size protocol as native/ultragroth_capi.cpp (the
// public headers native/include/ultragroth/prover.h and verifier.h), with
// the compute path the embedded ultragroth_tpu_torch runtime (CPython
// embedding; one interpreter per process, initialized lazily and guarded
// by the GIL).  Built at first use by
// ultragroth_tpu_torch.capi.build_libraries()
// into the port's build directory as libultragroth.so.
//
// Error-code and buffer-size protocol parity: src/prover.cpp:119-141
// (PROVER_ERROR_SHORT_BUFFER with required sizes written back) and
// src/verifier.h:9-11 (VALID=0 / INVALID=1 / ERROR=2).
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#define PROVER_OK 0x0
#define PROVER_ERROR 0x1
#define PROVER_ERROR_SHORT_BUFFER 0x2
#define PROVER_INVALID_WITNESS_LENGTH 0x3

#define VERIFIER_VALID_PROOF 0x0
#define VERIFIER_INVALID_PROOF 0x1
#define VERIFIER_ERROR 0x2

namespace {

std::once_flag g_init_once;

void ensure_python() {
    std::call_once(g_init_once, [] {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
        }
    });
}

void set_error(char *error_msg, unsigned long long maxsize,
               const std::string &msg) {
    if (error_msg && maxsize) {
        strncpy(error_msg, msg.c_str(), maxsize - 1);
        error_msg[maxsize - 1] = '\0';
    }
}

std::string py_error_string() {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    std::string out = "python error";
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            out = PyUnicode_AsUTF8(s);
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    return out;
}

// Call ultragroth_tpu_torch.capi.<fn>(args...) -> PyObject* (new ref) or null.
PyObject *call_api(const char *fn, PyObject *args) {
    PyObject *mod = PyImport_ImportModule("ultragroth_tpu_torch.capi");
    if (!mod) return nullptr;
    PyObject *f = PyObject_GetAttrString(mod, fn);
    Py_DECREF(mod);
    if (!f) return nullptr;
    PyObject *res = PyObject_CallObject(f, args);
    Py_DECREF(f);
    return res;
}

// Marshal a (proof_json, public_json) result tuple into the caller's
// buffers with the reference's short-buffer protocol.  Consumes nothing;
// caller owns `res`.
int marshal_prove_result(PyObject *res, char *proof_buffer,
                         unsigned long long *proof_size, char *public_buffer,
                         unsigned long long *public_size, char *error_msg,
                         unsigned long long error_msg_maxsize) {
    const char *proof_json = nullptr, *public_json = nullptr;
    if (!PyArg_ParseTuple(res, "ss", &proof_json, &public_json)) {
        set_error(error_msg, error_msg_maxsize, py_error_string());
        return PROVER_ERROR;
    }
    unsigned long long need_proof = strlen(proof_json) + 1;
    unsigned long long need_public = strlen(public_json) + 1;
    if (need_proof > *proof_size || need_public > *public_size) {
        *proof_size = need_proof;
        *public_size = need_public;
        set_error(error_msg, error_msg_maxsize, "short buffer");
        return PROVER_ERROR_SHORT_BUFFER;
    }
    memcpy(proof_buffer, proof_json, need_proof);
    memcpy(public_buffer, public_json, need_public);
    *proof_size = need_proof;
    *public_size = need_public;
    return PROVER_OK;
}

int prover_error_code(const std::string &err) {
    return err.rfind("Invalid witness length", 0) == 0
               ? PROVER_INVALID_WITNESS_LENGTH
               : PROVER_ERROR;
}

int prove_call(const char *pyfn, PyObject *args, char *proof_buffer,
               unsigned long long *proof_size, char *public_buffer,
               unsigned long long *public_size, char *error_msg,
               unsigned long long error_msg_maxsize) {
    // caller holds the GIL and owns `args`
    PyObject *res = args ? call_api(pyfn, args) : nullptr;
    if (!res) {
        std::string err = py_error_string();
        set_error(error_msg, error_msg_maxsize, err);
        return prover_error_code(err);
    }
    int rc = marshal_prove_result(res, proof_buffer, proof_size,
                                  public_buffer, public_size, error_msg,
                                  error_msg_maxsize);
    Py_DECREF(res);
    return rc;
}

int prove_impl(const char *pyfn, const void *zkey_buffer,
               unsigned long long zkey_size, const void *wtns_buffer,
               unsigned long long wtns_size, char *proof_buffer,
               unsigned long long *proof_size, char *public_buffer,
               unsigned long long *public_size, char *error_msg,
               unsigned long long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *args = Py_BuildValue(
        "(y#y#)", (const char *)zkey_buffer, (Py_ssize_t)zkey_size,
        (const char *)wtns_buffer, (Py_ssize_t)wtns_size);
    int rc = prove_call(pyfn, args, proof_buffer, proof_size, public_buffer,
                        public_size, error_msg, error_msg_maxsize);
    Py_XDECREF(args);
    PyGILState_Release(g);
    return rc;
}

// -- handle API: the prover object is an owned PyObject* of the Python
//    Groth16Prover / UltraGrothProver (create-once / prove-many contract,
//    the reference's src/prover.h:80-163, impl src/prover.cpp:144-309) --

int create_impl(const char *pyfn, void **prover_object, PyObject *args,
                char *error_msg, unsigned long long error_msg_maxsize) {
    // caller holds the GIL and owns `args`
    if (!prover_object) {
        set_error(error_msg, error_msg_maxsize, "null prover_object");
        return PROVER_ERROR;
    }
    PyObject *obj = args ? call_api(pyfn, args) : nullptr;
    if (!obj) {
        set_error(error_msg, error_msg_maxsize, py_error_string());
        *prover_object = nullptr;
        return PROVER_ERROR;
    }
    *prover_object = (void *)obj;
    return PROVER_OK;
}

int create_buf_impl(const char *pyfn, void **prover_object,
                    const void *zkey_buffer, unsigned long long zkey_size,
                    char *error_msg, unsigned long long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *args = Py_BuildValue("(y#)", (const char *)zkey_buffer,
                                   (Py_ssize_t)zkey_size);
    int rc = create_impl(pyfn, prover_object, args, error_msg,
                         error_msg_maxsize);
    Py_XDECREF(args);
    PyGILState_Release(g);
    return rc;
}

int create_file_impl(const char *pyfn, void **prover_object,
                     const char *zkey_file_path, char *error_msg,
                     unsigned long long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *args = Py_BuildValue("(s)", zkey_file_path);
    int rc = create_impl(pyfn, prover_object, args, error_msg,
                         error_msg_maxsize);
    Py_XDECREF(args);
    PyGILState_Release(g);
    return rc;
}

int handle_prove_impl(void *prover_object, const void *wtns_buffer,
                      unsigned long long wtns_size, char *proof_buffer,
                      unsigned long long *proof_size, char *public_buffer,
                      unsigned long long *public_size, char *error_msg,
                      unsigned long long error_msg_maxsize) {
    if (!prover_object) {
        set_error(error_msg, error_msg_maxsize, "null prover_object");
        return PROVER_ERROR;
    }
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *args = Py_BuildValue("(Oy#)", (PyObject *)prover_object,
                                   (const char *)wtns_buffer,
                                   (Py_ssize_t)wtns_size);
    int rc = prove_call("prover_prove", args, proof_buffer, proof_size,
                        public_buffer, public_size, error_msg,
                        error_msg_maxsize);
    Py_XDECREF(args);
    PyGILState_Release(g);
    return rc;
}

void destroy_impl(void *prover_object) {
    if (!prover_object) return;
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    Py_DECREF((PyObject *)prover_object);
    PyGILState_Release(g);
}

int verify_impl(const char *pyfn, const char *proof, const char *inputs,
                const char *verification_key, char *error_msg,
                unsigned long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = VERIFIER_ERROR;
    PyObject *args = Py_BuildValue("(sss)", proof, inputs, verification_key);
    PyObject *res = args ? call_api(pyfn, args) : nullptr;
    Py_XDECREF(args);
    if (res) {
        rc = (int)PyLong_AsLong(res);
        Py_DECREF(res);
    } else {
        set_error(error_msg, error_msg_maxsize, py_error_string());
    }
    PyGILState_Release(g);
    return rc;
}

int public_size_impl(const char *pyfn, const void *zkey_buffer,
                     unsigned long long zkey_size,
                     unsigned long long *public_size, char *error_msg,
                     unsigned long long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = PROVER_ERROR;
    PyObject *args = Py_BuildValue("(y#)", (const char *)zkey_buffer,
                                   (Py_ssize_t)zkey_size);
    PyObject *res = args ? call_api(pyfn, args) : nullptr;
    Py_XDECREF(args);
    if (res) {
        *public_size = (unsigned long long)PyLong_AsUnsignedLongLong(res);
        Py_DECREF(res);
        rc = PROVER_OK;
    } else {
        set_error(error_msg, error_msg_maxsize, py_error_string());
    }
    PyGILState_Release(g);
    return rc;
}

}  // namespace

extern "C" {

int groth16_prover(const void *zkey_buffer, unsigned long long zkey_size,
                   const void *wtns_buffer, unsigned long long wtns_size,
                   char *proof_buffer, unsigned long long *proof_size,
                   char *public_buffer, unsigned long long *public_size,
                   char *error_msg, unsigned long long error_msg_maxsize) {
    return prove_impl("groth16_prove", zkey_buffer, zkey_size, wtns_buffer,
                      wtns_size, proof_buffer, proof_size, public_buffer,
                      public_size, error_msg, error_msg_maxsize);
}

int ultra_groth_prover(const void *zkey_buffer, unsigned long long zkey_size,
                       const void *wtns_buffer, unsigned long long wtns_size,
                       char *proof_buffer, unsigned long long *proof_size,
                       char *public_buffer, unsigned long long *public_size,
                       char *error_msg, unsigned long long error_msg_maxsize) {
    return prove_impl("ultra_groth_prove", zkey_buffer, zkey_size, wtns_buffer,
                      wtns_size, proof_buffer, proof_size, public_buffer,
                      public_size, error_msg, error_msg_maxsize);
}

int groth16_public_size_for_zkey_buf(const void *zkey_buffer,
                                     unsigned long long zkey_size,
                                     unsigned long long *public_size,
                                     char *error_msg,
                                     unsigned long long error_msg_maxsize) {
    return public_size_impl("groth16_public_size", zkey_buffer, zkey_size,
                            public_size, error_msg, error_msg_maxsize);
}

int ultra_groth_public_size_for_zkey_buf(
    const void *zkey_buffer, unsigned long long zkey_size,
    unsigned long long *public_size, char *error_msg,
    unsigned long long error_msg_maxsize) {
    return public_size_impl("ultra_groth_public_size", zkey_buffer, zkey_size,
                            public_size, error_msg, error_msg_maxsize);
}

// `void` return parity with prover.h:62-71
void groth16_proof_size(unsigned long long *proof_size) {
    *proof_size = 810;  // src/prover.cpp:55-58
}

void ultra_groth_proof_size(unsigned long long *proof_size) {
    *proof_size = 1400;  // src/prover.cpp:61-64
}

int groth16_public_size_for_zkey_file(const char *zkey_fname,
                                      unsigned long long *public_size,
                                      char *error_msg,
                                      unsigned long long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = PROVER_ERROR;
    PyObject *args = Py_BuildValue("(s)", zkey_fname);
    PyObject *res = args ? call_api("groth16_public_size_file", args)
                         : nullptr;
    Py_XDECREF(args);
    if (res) {
        *public_size = (unsigned long long)PyLong_AsUnsignedLongLong(res);
        Py_DECREF(res);
        rc = PROVER_OK;
    } else {
        set_error(error_msg, error_msg_maxsize, py_error_string());
    }
    PyGILState_Release(g);
    return rc;
}

int ultra_groth_public_size_for_zkey_file(
    const char *zkey_fname, unsigned long long *public_size, char *error_msg,
    unsigned long long error_msg_maxsize) {
    ensure_python();
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = PROVER_ERROR;
    PyObject *args = Py_BuildValue("(s)", zkey_fname);
    PyObject *res = args ? call_api("ultra_groth_public_size_file", args)
                         : nullptr;
    Py_XDECREF(args);
    if (res) {
        *public_size = (unsigned long long)PyLong_AsUnsignedLongLong(res);
        Py_DECREF(res);
        rc = PROVER_OK;
    } else {
        set_error(error_msg, error_msg_maxsize, py_error_string());
    }
    PyGILState_Release(g);
    return rc;
}

// -- handle API (prover.h:80-163) -------------------------------------------

int groth16_prover_create(void **prover_object, const void *zkey_buffer,
                          unsigned long long zkey_size, char *error_msg,
                          unsigned long long error_msg_maxsize) {
    return create_buf_impl("groth16_create", prover_object, zkey_buffer,
                           zkey_size, error_msg, error_msg_maxsize);
}

int ultra_groth_prover_create(void **prover_object, const void *zkey_buffer,
                              unsigned long long zkey_size, char *error_msg,
                              unsigned long long error_msg_maxsize) {
    return create_buf_impl("ultra_groth_create", prover_object, zkey_buffer,
                           zkey_size, error_msg, error_msg_maxsize);
}

int groth16_prover_create_zkey_file(void **prover_object,
                                    const char *zkey_file_path,
                                    char *error_msg,
                                    unsigned long long error_msg_maxsize) {
    return create_file_impl("groth16_create_file", prover_object,
                            zkey_file_path, error_msg, error_msg_maxsize);
}

int ultra_groth_prover_create_zkey_file(
    void **prover_object, const char *zkey_file_path, char *error_msg,
    unsigned long long error_msg_maxsize) {
    return create_file_impl("ultra_groth_create_file", prover_object,
                            zkey_file_path, error_msg, error_msg_maxsize);
}

int groth16_prover_prove(void *prover_object, const void *wtns_buffer,
                         unsigned long long wtns_size, char *proof_buffer,
                         unsigned long long *proof_size, char *public_buffer,
                         unsigned long long *public_size, char *error_msg,
                         unsigned long long error_msg_maxsize) {
    return handle_prove_impl(prover_object, wtns_buffer, wtns_size,
                             proof_buffer, proof_size, public_buffer,
                             public_size, error_msg, error_msg_maxsize);
}

int ultra_groth_prover_prove(void *prover_object, const void *wtns_buffer,
                             unsigned long long wtns_size, char *proof_buffer,
                             unsigned long long *proof_size,
                             char *public_buffer,
                             unsigned long long *public_size, char *error_msg,
                             unsigned long long error_msg_maxsize) {
    return handle_prove_impl(prover_object, wtns_buffer, wtns_size,
                             proof_buffer, proof_size, public_buffer,
                             public_size, error_msg, error_msg_maxsize);
}

void groth16_prover_destroy(void *prover_object) {
    destroy_impl(prover_object);
}

void ultra_groth_prover_destroy(void *prover_object) {
    destroy_impl(prover_object);
}

// -- file-path one-shots (prover.h:199-236) ----------------------------------

int groth16_prover_zkey_file(const char *zkey_file_path,
                             const void *wtns_buffer,
                             unsigned long long wtns_size, char *proof_buffer,
                             unsigned long long *proof_size,
                             char *public_buffer,
                             unsigned long long *public_size, char *error_msg,
                             unsigned long long error_msg_maxsize) {
    void *obj = nullptr;
    int rc = groth16_prover_create_zkey_file(&obj, zkey_file_path, error_msg,
                                             error_msg_maxsize);
    if (rc != PROVER_OK) return rc;
    rc = groth16_prover_prove(obj, wtns_buffer, wtns_size, proof_buffer,
                              proof_size, public_buffer, public_size,
                              error_msg, error_msg_maxsize);
    groth16_prover_destroy(obj);
    return rc;
}

int ultra_groth_prover_zkey_file(
    const char *zkey_file_path, const void *wtns_buffer,
    unsigned long long wtns_size, char *proof_buffer,
    unsigned long long *proof_size, char *public_buffer,
    unsigned long long *public_size, char *error_msg,
    unsigned long long error_msg_maxsize) {
    void *obj = nullptr;
    int rc = ultra_groth_prover_create_zkey_file(&obj, zkey_file_path,
                                                 error_msg,
                                                 error_msg_maxsize);
    if (rc != PROVER_OK) return rc;
    rc = ultra_groth_prover_prove(obj, wtns_buffer, wtns_size, proof_buffer,
                                  proof_size, public_buffer, public_size,
                                  error_msg, error_msg_maxsize);
    ultra_groth_prover_destroy(obj);
    return rc;
}

int groth16_verify(const char *proof, const char *inputs,
                   const char *verification_key, char *error_msg,
                   unsigned long error_msg_maxsize) {
    return verify_impl("groth16_verify", proof, inputs, verification_key,
                       error_msg, error_msg_maxsize);
}

int ultra_groth_verify(const char *proof, const char *inputs,
                       const char *verification_key, char *error_msg,
                       unsigned long error_msg_maxsize) {
    return verify_impl("ultra_groth_verify", proof, inputs, verification_key,
                       error_msg, error_msg_maxsize);
}

}  // extern "C"
